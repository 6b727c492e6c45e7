"""Table 7 (beyond paper): multi-stream continuous-batching serve bench.

The port's counterpart of ``benchmarks/table7_serve_mt.py``. Drives the
serve engine with N concurrent synthetic request streams — staggered
arrivals, mixed prompt/generation lengths — over a packed W4 artifact,
once with the int8 paged KV cache (read by the ``kv_decode`` kernel on the
card) and once with fp16 KV pools as the reference mode. Written to
``artifacts/bench_torch/BENCH_serve_mt.json`` (``--out`` to override),
never to the JAX package's tracked ``BENCH_serve_mt.json``:

  * sustained tok/s (all generated tokens / serving wall, set-up kept
    out),
  * mean resident KV bytes per active stream (pages-in-use x bytes/page,
    sampled every decode tick),
  * mean decode-slot occupancy,
  * the headline ratio: fp16 resident KV bytes / int8 resident KV bytes
    (int8 codes + f16 scales vs f16 values).

Both passes use identical arrivals and lengths (same seed, and page
consumption depends only on lengths), so the byte ratio is exact, not
sampled noise.

A third section, ``pressure``, replays the same arrivals on a pool cut
to ``--pool-frac`` of worst-case demand, once under worst-case
reservation (``overcommit='none'``) and once under optimistic admission
(``overcommit='prompt'``: slots pack, the scheduler preempts on
exhaustion). Tracked: the occupancy gain, the preemption/replay/expired/
failed/cancelled counters and the preemption overhead (replayed prefill
chunks per decode tick), all guarded by ``scripts/check_serve_bench.py``.

The reduced config by default, as the reference; ``--full`` (``bench(
reduced=False)``) serves brecq-lm-100m at full width and depth. Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.deploy import QuantizedArtifact, rtn_artifact
from repro_torch.device import resolve
from repro_torch.models import get_model
from repro_torch.serve_engine import EngineConfig, ServeEngine

from . import common
from .common import device_name

SCHEMA_KEYS = ("config", "int8", "fp16", "kv_bytes_ratio_fp16_over_int8",
               "sustained_tok_s_int8", "pressure")
RUN_KEYS = ("sustained_tok_s", "tokens_generated", "mean_slot_occupancy",
            "mean_resident_kv_bytes_per_stream", "bytes_per_page",
            "peak_pages_in_use", "compile_s", "decode_ticks",
            "preemptions", "replay_prefill_chunks", "expired", "failed",
            "cancelled")


def mt_json() -> Path:
    return common.ART / "BENCH_serve_mt.json"


def engine_config(*, slots, page_size, prompt, gen, chunk, kv_dtype,
                  overcommit="none", num_pages=None, **over) -> EngineConfig:
    """The engine of a run: ``slots`` decode slots, a pool sized for the
    worst case unless ``num_pages`` says otherwise; ``over`` adds
    EngineConfig fields (a backend, recorded logits)."""
    max_len = prompt + gen
    pages_per = -(-max_len // page_size)
    return EngineConfig(num_slots=slots, page_size=page_size,
                        num_pages=num_pages or 1 + slots * pages_per,
                        max_len=max_len, prefill_chunk=min(chunk, prompt),
                        kv_dtype=kv_dtype, overcommit=overcommit, **over)


def draw_streams(vocab, *, streams, prompt, gen, seed) -> tuple:
    """(arrival ticks, prompts, generation lengths) of ``streams`` streams,
    drawn from ``seed`` in the reference's order."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.integers(0, 2 * streams, streams))
    arrivals[0] = 0
    plens = rng.integers(max(prompt // 2, 1), prompt + 1, streams)
    gens = rng.integers(max(gen // 2, 1), gen + 1, streams)
    prompts = [rng.integers(0, vocab, size=int(plens[i]))
               for i in range(streams)]
    return arrivals, prompts, gens


def drive(eng, arrivals, prompts, gens) -> None:
    """Submit each stream at its arrival tick; step until all are done."""
    nxt, streams = 0, len(prompts)
    while nxt < streams or eng.pending():
        while nxt < streams and arrivals[nxt] <= eng.tick:
            eng.submit(prompts[nxt], int(gens[nxt]))
            nxt += 1
        eng.step()


def run_streams(model, weights, hook, kv_dtype, *, streams, slots, prompt,
                gen, chunk, page_size, seed, overcommit="none",
                num_pages=None) -> dict:
    """One full engine run; returns engine metrics + completion proof."""
    ecfg = engine_config(slots=slots, page_size=page_size, prompt=prompt,
                         gen=gen, chunk=chunk, kv_dtype=kv_dtype,
                         overcommit=overcommit, num_pages=num_pages)
    eng = ServeEngine(model, weights, ecfg, quant=hook)
    eng.compile()
    drive(eng, *draw_streams(model.cfg.vocab, streams=streams, prompt=prompt,
                             gen=gen, seed=seed))
    eng.assert_no_leaks()  # zero leaked pages is part of the bench contract
    done = sum(r.state == "done" for r in eng.requests.values())
    if done != streams:
        raise RuntimeError(f"only {done}/{streams} streams completed")
    m = eng.metrics()
    m["streams_completed"] = done
    m["leaked_pages"] = eng.pool.pages_in_use  # 0 — checked above
    return m


def _round_run(m: dict) -> dict:
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in m.items() if k in RUN_KEYS
            or k in ("streams_completed", "leaked_pages")}


def bench(streams=64, slots=16, prompt=48, gen=48, chunk=32, page_size=16,
          seed=0, pool_frac=0.35, arch="brecq_lm_100m", out=None, *,
          reduced: bool = True, device=None) -> dict:
    """The int8 and fp16 runs and the pressure pair; writes ``out``
    (default ``artifacts/bench_torch/BENCH_serve_mt.json``). Params from
    ``seed`` on ``device``; ``reduced=False`` serves the full width and
    depth (the one departure from the reference)."""
    dev = resolve(device)
    cfg, model = get_model(arch, reduced=reduced)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    # serve what deployment ships: packed W4, saved + reloaded verified
    with tempfile.TemporaryDirectory(prefix="brecq_mt_") as d:
        rtn_artifact(params, 4, cfg=cfg).save(d)
        art = QuantizedArtifact.load(d).to(dev)
    kw = dict(streams=streams, slots=slots, prompt=prompt, gen=gen,
              chunk=chunk, page_size=page_size, seed=seed)

    runs = {}
    for kv_dtype in ("int8", "float16"):
        m = run_streams(model, art.params, art.hook(), kv_dtype, **kw)
        key = "fp16" if kv_dtype == "float16" else kv_dtype
        runs[key] = _round_run(m)
        print(f"[{key}] {streams} streams/{slots} slots: "
              f"{m['tokens_generated']} tokens, "
              f"{m['sustained_tok_s']:.1f} tok/s sustained, occupancy "
              f"{m['mean_slot_occupancy']:.2f}, resident KV "
              f"{m['mean_resident_kv_bytes_per_stream']/1e3:.1f} KB/stream")

    # pressure: identical arrivals on a pool at pool_frac of worst-case
    # demand. Worst-case reservation serializes admission; optimistic
    # 'prompt' admission packs slots and preempts on exhaustion — every
    # stream must still complete with zero leaked pages.
    pages_per = -(-(prompt + gen) // page_size)
    press_pages = 1 + max(pages_per, int(pool_frac * slots * pages_per))
    pressure = {"pool_frac": pool_frac, "num_pages": press_pages}
    for oc in ("none", "prompt"):
        m = run_streams(model, art.params, art.hook(), "int8",
                        overcommit=oc, num_pages=press_pages, **kw)
        pressure[oc] = _round_run(m)
        print(f"[pressure/{oc}] occupancy {m['mean_slot_occupancy']:.2f}, "
              f"{m['sustained_tok_s']:.1f} tok/s, "
              f"{m['preemptions']} preemptions "
              f"({m['replay_prefill_chunks']} replayed chunks / "
              f"{m['decode_ticks']} decode ticks)")
    pressure["occupancy_gain"] = round(
        pressure["prompt"]["mean_slot_occupancy"]
        / max(pressure["none"]["mean_slot_occupancy"], 1e-9), 3)
    pressure["preemption_overhead"] = round(
        pressure["prompt"]["replay_prefill_chunks"]
        / max(pressure["prompt"]["decode_ticks"], 1), 3)

    ratio = (runs["fp16"]["mean_resident_kv_bytes_per_stream"]
             / max(runs["int8"]["mean_resident_kv_bytes_per_stream"], 1e-9))
    out_doc = {
        "config": {"arch": arch, "reduced": reduced, "streams": streams,
                   "slots": slots, "prompt_len": prompt, "gen_len": gen,
                   "prefill_chunk": chunk, "page_size": page_size,
                   "w_bits": 4, "seed": seed, "pool_frac": pool_frac,
                   "backend": dev.type, "device_name": device_name(dev)},
        "int8": runs["int8"],
        "fp16": runs["fp16"],
        "pressure": pressure,
        "kv_bytes_ratio_fp16_over_int8": round(ratio, 3),
        "sustained_tok_s_int8": runs["int8"]["sustained_tok_s"],
    }
    path = Path(out) if out is not None else mt_json()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out_doc, indent=1) + "\n")
    print(f"serve-mt bench -> {path}: int8 KV "
          f"{ratio:.2f}x lower resident bytes/stream than fp16 "
          f"({runs['int8']['sustained_tok_s']} tok/s sustained); overcommit "
          f"occupancy x{pressure['occupancy_gain']:.2f} over worst-case at "
          f"{pool_frac:.0%} pool ({pressure['prompt']['preemptions']} "
          "preemptions)")
    return out_doc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--streams", type=int, default=64)
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--prompt", type=int, default=48)
    p.add_argument("--gen", type=int, default=48)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pool-frac", type=float, default=0.35,
                   help="pressure-section pool size as a fraction of "
                        "worst-case page demand")
    p.add_argument("--out", default=None,
                   help="default: artifacts/bench_torch/BENCH_serve_mt.json")
    p.add_argument("--full", action="store_true",
                   help="brecq-lm-100m at full width and depth (default: the "
                        "reduced config, as the reference)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    args = p.parse_args(argv)
    return bench(streams=args.streams, slots=args.slots, prompt=args.prompt,
                 gen=args.gen, chunk=args.chunk, page_size=args.page_size,
                 seed=args.seed, pool_frac=args.pool_frac, out=args.out,
                 reduced=not args.full, device=args.device)


if __name__ == "__main__":
    main()
