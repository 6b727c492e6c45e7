"""Serving window: requests arriving at the mix's fixed rate against the
port's ``ServeEngine``.

Set-up packs the model on the device one layer at a time: each layer's FP
weights are made from the seed, packed into the mix's RTN artifact
(``deploy/artifact.py::rtn_artifact``) and freed, so no FP copy of the
model is ever whole. It builds the engine at the mix's shape and KV pool,
warms it (``compile()``, then two requests through the real pool: the
longest prompt the mix can draw and a short one), and resets the card's
peak memory, so ``memory_peak_bytes`` is the engine's state and what
serving adds to it. The window then submits each request of the mix at
its arrival time (``traffic.arrivals``) and calls ``engine.step()`` while
there is work, until ``--seconds`` have passed. Tokens are timed when
``step()`` hands them back, and a request's time to first token runs from
its arrival.

After the window the engine is freed and the plain reference
(``reference/model.py``), built layer by layer from the same seed, runs
once over each of a sample of the finished requests, drawn from the seed
with the longest among them: the compared number is the widest gap by which
a served token's reference logit lies below the reference's best at its
position.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, port, stats, traffic, weights
from perfbench.trace import CallBounds, Window
from perfbench.work import flops as wflops


def engine_config(mix: dict):
    from repro_torch.serve_engine.engine import EngineConfig

    e = mix["engine"]
    pages = -(-e["pool_tokens"] // e["page_size"]) + 1  # + the sink
    return EngineConfig(num_slots=e["num_slots"], page_size=e["page_size"],
                        num_pages=pages, max_len=e["max_len"],
                        prefill_chunk=e["prefill_chunk"], kv_dtype=e["kv_dtype"],
                        overcommit=e["overcommit"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _tree(flat: dict) -> dict:
    out: dict = {}
    for p, t in flat.items():
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = t
    return out


def pack(config: dict, mix: dict, seed: int, device):
    """The packed tree, one layer at a time, and the serving hook."""
    from repro_torch.deploy import rtn_artifact

    arch, model = port.model(config)
    lay = weights.Layout(model)
    a, e = mix["artifact"], mix["engine"]

    def artifact(flat):
        return rtn_artifact(_tree(flat), a["w_bits"], a["group"], cfg=arch,
                            kv_dtype=e["kv_dtype"], kv_page_size=e["page_size"])

    art = artifact(weights.top(lay, seed, device))
    packed = dict(_leaves(art.params))
    body: dict = {}
    for i in range(lay.n_layers):
        one = artifact({("body",) + q: t[None] for q, t in
                        weights.layer(lay, seed, i, device).items()})
        for p, t in _leaves(one.params):
            if p not in body:
                body[p] = torch.empty((lay.n_layers,) + tuple(t.shape[1:]), dtype=t.dtype,
                                      device=device)
            body[p][i] = t[0]
        del one
    packed.update(body)
    return model, _tree(packed), art.hook()


def build(config: dict, mix: dict, seed: int, device):
    """The warmed engine and the seconds of each step of set-up."""
    from repro_torch.serve_engine.engine import ServeEngine

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t = [time.perf_counter()]
    model, params, hook = pack(config, mix, seed, device)
    engine = ServeEngine(model, params, engine_config(mix), quant=hook)
    del params
    sync()
    t.append(time.perf_counter())
    engine.compile()
    rng = np.random.default_rng(seed + 1)
    for n in (mix["prompt"]["max"], mix["prompt"]["min"]):
        engine.submit(rng.integers(0, config["vocab_size"], n).astype(np.int32), 2)
    while engine.pending():
        engine.step()
    sync()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t.append(time.perf_counter())
    return engine, dict(zip(("pack_s", "warm_s"), np.diff(t).tolist()))


def _range_flops(cfg: dict, a: int, b: int) -> float:
    """Tokens at positions a..b-1 without their logits."""
    n = b - a
    if n <= 0:
        return 0.0
    per = wflops.serve_token_flops(cfg, 0, False) - wflops.attention_flops(cfg, 1)
    keys = (a + 1 + b) * n / 2.0  # sum of (p + 1)
    return per * n + wflops.attention_flops(cfg, keys)


def window(engine, config: dict, mix: dict, seed: int, seconds: float, trace: bool,
           rate: float | None = None, backlog: int | None = None):
    """Serve the mix's arrivals for ``seconds``; the end-to-end numbers, what
    the readers read, every request's state, and the traced part."""
    reqs = traffic.draw(mix, seed, config["vocab_size"])
    arrive = traffic.arrivals(mix, seconds, rate, backlog)
    head = wflops.serve_token_flops(config, 0, True) - wflops.serve_token_flops(config, 0, False)
    m0 = engine.metrics()
    bounds = CallBounds("qmm").install() if trace else None
    tw = Window() if trace else None
    tr_start, tr_len = 0.3 * seconds, min(6.0, 0.4 * seconds)

    t_arr: dict[int, float] = {}
    tok_t: dict[int, list[float]] = {}
    seen_gen: dict[int, int] = {}
    seen_off: dict[int, int] = {}
    inflight: list[int] = []
    ticks: list[float] = []
    min_waiting = None
    prefilled = generated = 0
    model_flops = 0.0
    k = 0
    traced = 0  # 0 before the traced part, 1 in it, 2 after
    t0 = time.perf_counter()
    t_end = t0
    try:
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            if tw is not None and traced == 0 and now >= tr_start:
                tw.start()
                bounds.active, traced = True, 1
            elif traced == 1 and now >= tr_start + tr_len:
                bounds.active, traced = False, 2
                tw.stop()
            while k < len(arrive) and arrive[k] <= now:
                prompt, max_new = reqs[k % len(reqs)]
                uid = engine.submit(prompt, max_new)
                t_arr[uid] = t0 + float(arrive[k])
                tok_t[uid], seen_gen[uid], seen_off[uid] = [], 0, 0
                inflight.append(uid)
                k += 1
            if not engine.pending():
                time.sleep(0.0005)
                continue
            ts = time.perf_counter()
            engine.step()
            te = time.perf_counter()
            ticks.append(te - ts)
            t_end = te
            n_wait = len(engine.waiting)
            min_waiting = n_wait if min_waiting is None else min(min_waiting, n_wait)
            still = []
            for uid in inflight:
                r = engine.requests[uid]
                n_p = len(r.prompt)
                off = min(r.prefill_off, n_p) if not r.generated else n_p
                if off > seen_off[uid]:
                    prefilled += off - seen_off[uid]
                    model_flops += _range_flops(config, seen_off[uid], off)
                    seen_off[uid] = off
                n = len(r.generated)
                if n > seen_gen[uid]:
                    for j in range(seen_gen[uid], n):
                        tok_t[uid].append(te)
                        model_flops += head
                        if j >= 1:  # a decode step fed token j-1 at its position
                            model_flops += _range_flops(config, n_p + j - 1, n_p + j)
                    generated += n - seen_gen[uid]
                    seen_gen[uid] = n
                if r.state in ("waiting", "prefill", "decode"):
                    still.append(uid)
            inflight = still
    finally:
        if tw is not None:
            if traced == 1:
                tw.stop()
            bounds.remove()
    t_end = max(t_end, t0 + min(seconds, time.perf_counter() - t0))
    win = t_end - t0
    m1 = engine.metrics()

    ttft, itl = [], []
    for uid, ts_ in tok_t.items():
        ttft.append((ts_[0] if ts_ else t_end) - t_arr[uid])
        itl.extend(b - a for a, b in zip(ts_, ts_[1:]))
    states = {uid: engine.requests[uid].state for uid in t_arr}
    facts = {
        "window_s": win, "ticks": ticks,
        "prefilled": prefilled, "generated": generated, "model_flops": model_flops,
        "decode_ticks": m1["decode_ticks"] - m0["decode_ticks"],
        "tokens_generated": m1["tokens_generated"] - m0["tokens_generated"],
        "qmm_bound_s": bounds.bound_s if bounds else 0.0,
        "qmm_calls": bounds.calls if bounds else 0,
        "requests": len(t_arr), "finished": sum(s == "done" for s in states.values()),
        "waiting_at_close": sum(s == "waiting" for s in states.values()),
        "n_ticks": len(ticks), "min_waiting": -1 if min_waiting is None else min_waiting,
        "ttft_p50_ms": stats.pct(ttft, 50) * 1e3,
    }
    e2e = {"serve_tok_s": (prefilled + generated) / win,
           "ttft_p95_ms": stats.pct(ttft, 95) * 1e3,
           "itl_p95_ms": stats.pct(itl, 95) * 1e3}
    return e2e, facts, states, tw


def sample(engine, states: dict, mix: dict, seed: int) -> list[int]:
    """Finished requests to judge: the one with most served tokens, then the
    rest in the seed's order, until the mix's token count and request
    count are both reached (or ``max_requests``)."""
    done = sorted(u for u, s in states.items() if s == "done")
    if not done:
        return []
    longest = max(done, key=lambda u: (len(engine.requests[u].generated), -u))
    rest = [u for u in done if u != longest]
    rest = [rest[i] for i in np.random.default_rng(seed ^ 0x5EED).permutation(len(rest))]
    out, toks = [], 0
    for u in [longest] + rest:
        c = mix["check"]
        if (toks >= c["tokens"] and len(out) >= c["min_requests"]) or len(out) >= c["max_requests"]:
            break
        out.append(u)
        toks += len(engine.requests[u].generated)
    return out


def served(engine, uids: list[int]) -> list[tuple[np.ndarray, list[int], list[int]]]:
    """(prompt, served tokens, the tokens to judge) of each request: the
    program's answer is its served tokens."""
    out = []
    for u in uids:
        r = engine.requests[u]
        out.append((r.prompt, list(r.generated), list(r.generated)))
    return out


def reference(config: dict, mix: dict, seed: int, device, dtype=torch.float32):
    """The plain reference, built layer by layer from the seed's weights."""
    from perfbench.reference.model import DenseRef, no_tf32

    no_tf32()
    _arch, model = port.model(config)
    lay = weights.Layout(model)
    return DenseRef(config, mix["artifact"]["w_bits"], weights.top(lay, seed, device),
                    lambda i: weights.layer(lay, seed, i, device),
                    mix["engine"]["kv_dtype"], dtype)


def judge(ref, picked: list, device) -> tuple[float, int]:
    """The widest reference-logit gap of the judged tokens, each at the
    position where its request's served tokens put it, and their count."""
    from perfbench.reference.model import served_gaps

    if not picked:
        return float("inf"), 0
    worst, n = 0.0, 0
    for prompt, gen, answer in picked:
        toks = torch.as_tensor(np.concatenate([prompt, np.asarray(gen[:-1], np.int32)]),
                               device=device)
        g = served_gaps(ref, toks, len(prompt), torch.as_tensor(answer, device=device))
        worst = max(worst, float(g.max()))
        n += len(answer)
    return worst, n


def checks(gap: float, mix: dict) -> list:
    return [("served_logit_gap", gap, mix["check"]["limit"])]


def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> harness.Run:
    torch.backends.cuda.matmul.allow_tf32 = False
    engine, steps = build(config, mix, seed, device)
    t_setup_end = time.perf_counter()
    e2e, facts, states, tw = window(engine, config, mix, seed, seconds, trace)
    facts.update(steps)
    e2e["setup_s"] = t_setup_end - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    picked = served(engine, sample(engine, states, mix, seed))
    failed = sum(s in ("failed", "expired", "cancelled") for s in states.values())
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gap, n_tok = judge(reference(config, mix, seed, device), picked, device)
    facts.update(ref_s=time.perf_counter() - t_ref, judged_requests=len(picked),
                 judged_tokens=n_tok)
    return harness.Run(end_to_end=e2e, attempted=len(states), failed=failed,
                       checks=checks(gap, mix), memory_peak_bytes=peak, facts=facts, trace=tw)
