"""Port parity: the continuous-batching serve engine
(repro_torch.serve_engine) vs the JAX package's ``repro.serve_engine``,
and the port's engine under pressure (``test_serve_pressure.py``'s
behaviours: overcommit with bit-exact preemption resume, victim order,
deadlines, typed rejects, stall reporting, drain), and the engine on
reduced deepseek-moe-16b (W4 experts on the grouped qmm tier, int8 pool).

Both engines serve the same reduced brecq-lm-100m weights (made with
numpy, carried with ``params_from_numpy``; the linear weights are scaled
up 3x so that greedy decode does not settle on one repeated token), FP
and packed W4, over
float32 and int8 paged pools, with ``test_serve_engine.py``'s config,
prompts and arrivals. Per-request greedy tokens are identical. Recorded
logits agree within 1e-4 for float32 pools (f32 sums in another order).
For int8 pools the tolerance is 0.05: a K/V value that lies within f32
noise of a rounding boundary can take the neighbouring int8 code in one
package, and one code step is 1/127 of its row's absolute maximum, which
moves a score or an attention output by up to ~1% of that row's range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.models import get_model as j_get_model
from repro.models.common import NO_QUANT as J_NO_QUANT
from repro import serve_engine as jse
from repro_torch import serve_engine as tse
from repro_torch.deploy import rtn_artifact
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.launch.watchdog import GracefulShutdown
from repro_torch.models.common import NO_QUANT
from test_torch_serve import np_params
from torch_threads import one_torch_thread  # noqa: F401


ECFG = dict(num_slots=3, page_size=4, num_pages=49, max_len=32,
            prefill_chunk=8, record_logits=True)
PROMPT_LENS = (5, 13, 9, 17, 6)
MAX_NEW = (6, 3, 9, 4, 5)
ARRIVALS = (0, 0, 2, 5, 9)
LOGIT_TOL = {"float32": 1e-4, "int8": 5e-2}


def prompts(vocab=512, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def weights():
    """{'fp' | 'w4': (jax (model, params, hook), port (model, params, hook))}"""
    p = np_params(seed=3, w_scale=3.0)
    jcfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    cfg, model = get_model("brecq_lm_100m", reduced=True)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")
    jart = j_rtn_artifact(jp, 4, None, cfg=jcfg)
    tart = rtn_artifact(tp, 4, None, cfg=cfg)
    return {"fp": ((jmodel, jp, J_NO_QUANT), (model, tp, NO_QUANT)),
            "w4": ((jmodel, jart.params, jart.hook()),
                   (model, tart.params, tart.hook()))}


def staggered(pkg, model, params, quant, kv_dtype, backend):
    """All requests in flight together, admitted on their arrival ticks."""
    eng = pkg.ServeEngine(model, params, pkg.EngineConfig(
        kv_dtype=kv_dtype, backend=backend, **ECFG), quant=quant)
    ps, nxt = prompts(), 0
    while nxt < len(ps) or eng.pending():
        while nxt < len(ps) and ARRIVALS[nxt] <= eng.tick:
            eng.submit(ps[nxt], MAX_NEW[nxt], uid=nxt)
            nxt += 1
        eng.step()
    return eng


def sequential(model, params, quant, kv_dtype):
    """The port's engine with one request at a time: batch-1 serving."""
    eng = tse.ServeEngine(model, params, tse.EngineConfig(kv_dtype=kv_dtype, **ECFG),
                          quant=quant)
    for uid, p in enumerate(prompts()):
        eng.submit(p, MAX_NEW[uid], uid=uid)
        eng.run()
    return eng


def tokens(eng):
    return {uid: list(r.generated) for uid, r in eng.requests.items()}


@pytest.fixture(scope="module")
def served(weights):
    """Port engine runs, staggered, keyed by (weights, kv dtype)."""
    return {(w, kv): staggered(tse, *weights[w][1], kv, "torch")
            for w in ("fp", "w4") for kv in ("float32", "int8")}


@pytest.mark.parametrize("w", ["fp", "w4"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_engine_matches_jax(weights, served, w, kv_dtype):
    jeng = staggered(jse, *weights[w][0], kv_dtype, "xla")
    teng = served[(w, kv_dtype)]
    assert tokens(teng) == tokens(jeng)
    for uid, req in teng.requests.items():
        assert req.state == "done" and len(req.generated) == MAX_NEW[uid]
        np.testing.assert_allclose(np.stack(req.logits),
                                   np.stack(jeng.requests[uid].logits),
                                   atol=LOGIT_TOL[kv_dtype], rtol=0)
    assert teng.metrics()["bytes_per_page"] == jeng.metrics()["bytes_per_page"]
    assert teng.events == jeng.events  # same schedule, tick for tick
    teng.assert_no_leaks()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_staggered_equals_sequential_bitwise(weights, served, kv_dtype):
    stag = served[("w4", kv_dtype)]
    seq = sequential(*weights["w4"][1], kv_dtype)
    assert tokens(stag) == tokens(seq)
    for uid in stag.requests:
        np.testing.assert_array_equal(np.stack(stag.requests[uid].logits),
                                      np.stack(seq.requests[uid].logits))
    seq.assert_no_leaks()


@pytest.fixture(scope="module")
def moe_w4():
    """Reduced deepseek-moe-16b, W4, per moe_impl: {impl: (jax (model,
    params, hook), port (model, params, hook))}; linear weights at 3x."""
    from test_torch_models import np_params as model_params

    jcfg, jmodel = j_get_model("deepseek_moe_16b", reduced=True)
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 3 if path[-1].key == "w" else a,
        model_params(jmodel, seed=3))
    jart = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=jcfg)
    tart = rtn_artifact(params_from_numpy(p, device="cpu"), 4, None, cfg=jcfg)
    out = {}
    for impl in ("dense", "capacity"):
        _, jm = j_get_model("deepseek_moe_16b", reduced=True, moe_impl=impl)
        _, tm = get_model("deepseek_moe_16b", reduced=True, moe_impl=impl)
        out[impl] = ((jm, jart.params, jart.hook()), (tm, tart.params, tart.hook()))
    return out


def moe_staggered(pkg, model, params, quant, backend):
    eng = pkg.ServeEngine(model, params, pkg.EngineConfig(
        kv_dtype="int8", backend=backend, **ECFG), quant=quant)
    ps, nxt = prompts(vocab=256), 0
    while nxt < len(ps) or eng.pending():
        while nxt < len(ps) and ARRIVALS[nxt] <= eng.tick:
            eng.submit(ps[nxt], MAX_NEW[nxt], uid=nxt)
            nxt += 1
        eng.step()
    return eng


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_moe_engine_matches_jax(moe_w4, impl):
    """Reduced deepseek-moe-16b, W4, int8 pool: the same tokens as the JAX
    engine (expert matmuls on the grouped qmm tier), and for the capacity
    impl staggered serving equals sequential serving bit for bit."""
    jw, tw = moe_w4[impl]
    jeng = moe_staggered(jse, *jw, "xla")
    teng = moe_staggered(tse, *tw, "torch")
    assert tokens(teng) == tokens(jeng)
    assert len({t for g in tokens(teng).values() for t in g}) > 3
    for uid, req in teng.requests.items():
        assert req.state == "done" and len(req.generated) == MAX_NEW[uid]
        np.testing.assert_allclose(np.stack(req.logits),
                                   np.stack(jeng.requests[uid].logits),
                                   atol=LOGIT_TOL["int8"], rtol=0)
    teng.assert_no_leaks()
    if impl == "capacity":
        seq = tse.ServeEngine(*tw[:2], tse.EngineConfig(kv_dtype="int8", **ECFG),
                              quant=tw[2])
        for uid, p in enumerate(prompts(vocab=256)):
            seq.submit(p, MAX_NEW[uid], uid=uid)
            seq.run()
        assert tokens(seq) == tokens(teng)
        for uid in teng.requests:
            np.testing.assert_array_equal(np.stack(teng.requests[uid].logits),
                                          np.stack(seq.requests[uid].logits))


def test_page_pool_matches_jax():
    """The same op sequence gives the same page ids and the same
    exceptions in both allocators."""
    ops = [("reserve", 1, 3), ("alloc", 1), ("alloc", 1), ("reserve", 2, 2),
           ("alloc", 2), ("add", 1, 3), ("add", 2, 1), ("alloc", 1),
           ("alloc", 1), ("alloc", 2), ("alloc", 2), ("reserve", 3, 1),
           ("free", 1), ("reserve", 1, 1), ("reserve", 3, 2), ("alloc", 3),
           ("alloc", 3), ("alloc", 3), ("free", 2), ("free", 3), ("free", 9)]

    def trace(pkg):
        pool, out = pkg.PagePool(8), []
        for op, *a in ops:
            try:
                res = {"reserve": pool.reserve, "alloc": pool.alloc,
                       "add": pool.add_reservation, "free": pool.free_owner}[op](*a)
            except Exception as e:  # noqa: BLE001 (the exception is the result)
                res = (type(e).__name__, str(e))
            out.append((res, pool.free_pages, pool.pages_in_use,
                        pool.reserved_pages, pool.available()))
        return out

    assert trace(tse) == trace(jse)
    pool = tse.PagePool(8)
    pool.check_no_leaks()
    with pytest.raises(tse.PagePoolExhausted):
        pool.reserve(0, 8)
    with pytest.raises(ValueError, match="at least 2 pages"):
        tse.PagePool(1)


def test_from_artifact_serves_jax_artifact(tmp_path, weights):
    jmodel, jp, _ = weights["fp"][0]
    jcfg, _ = j_get_model("brecq_lm_100m", reduced=True)
    j_rtn_artifact(jp, 4, 64, cfg=jcfg, kv_dtype="int8", kv_page_size=8).save(str(tmp_path))
    jeng = jse.ServeEngine.from_artifact(str(tmp_path), reduced=True)
    teng = tse.ServeEngine.from_artifact(str(tmp_path), reduced=True, device="cpu")
    assert (teng.cfg.kv_dtype, teng.cfg.page_size) == ("int8", 8)
    for eng in (jeng, teng):
        for uid, p in enumerate(prompts()[:3]):
            eng.submit(p, 4, uid=uid)
        eng.run()
    assert tokens(teng) == tokens(jeng)
    teng.assert_no_leaks()


def test_from_artifact_defaults_to_cuda(tmp_path, weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _, tp, _ = weights["fp"][1]
    cfg, _ = get_model("brecq_lm_100m", reduced=True)
    rtn_artifact(tp, 4, None, cfg=cfg).save(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tse.ServeEngine.from_artifact(str(tmp_path), reduced=True)


def test_rejects_oversized_and_non_attention(weights):
    from repro_torch.models.transformer import StackDef, SubLayer

    model, tp, _ = weights["fp"][1]
    eng = tse.ServeEngine(model, tp, tse.EngineConfig(kv_dtype="int8", **ECFG))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(30, np.int32), 10)
    # a recurrent arch builds, and its mixers stop at the pool, as in JAX
    _, xl = get_model("xlstm_350m", reduced=True)
    xp = xl.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="attention-only"):
        tse.ServeEngine(xl, xp, tse.EngineConfig(kv_dtype="int8", **ECFG))
    _, other = get_model("brecq_lm_100m", reduced=True)
    other.stacks = [StackDef("body", 4, (SubLayer("mlstm"),))]
    with pytest.raises(ValueError, match="attention-only"):
        tse.ServeEngine(other, tp, tse.EngineConfig(kv_dtype="int8", **ECFG))
    with pytest.raises(ValueError, match="backend"):
        tse.EngineConfig(backend="xla")


# ---------------------------------------------------------------------------
# pressure: test_serve_pressure.py's behaviours in the port
# ---------------------------------------------------------------------------

BASE = dict(num_slots=3, page_size=4, max_len=32, prefill_chunk=8,
            kv_dtype="float32", backend="torch")
RNG = np.random.default_rng(3)
PROMPTS = [RNG.integers(0, 331, size=n).astype(np.int32) for n in (6, 9, 7, 11)]
MAX_NEWS = (12, 14, 12, 10)


@pytest.fixture(scope="module")
def mk(weights):
    """Engine factory over the FP weights; engines of one program shape
    share the first one's programs."""
    model, tp, _ = weights["fp"][1]
    donors: dict = {}

    def make(**over):
        cfg = tse.EngineConfig(**{**BASE, **over})
        eng = tse.ServeEngine(model, tp, cfg,
                              share_compiled=donors.get(cfg.program_shape))
        donors.setdefault(cfg.program_shape, eng)
        return eng

    return make


def _storm(eng):
    for uid, (p, mn) in enumerate(zip(PROMPTS, MAX_NEWS)):
        eng.submit(p, mn, uid=uid)
    return eng


@pytest.fixture(scope="module")
def solo_refs(mk):
    """Each stream run alone on an uncontended pool: ground truth."""
    refs = {}
    for uid, (p, mn) in enumerate(zip(PROMPTS, MAX_NEWS)):
        e = mk(num_pages=49)
        e.submit(p, mn, uid=uid)
        e.run()
        refs[uid] = list(e.requests[uid].generated)
    return refs


def test_preemption_resumes_bit_exact(mk, solo_refs):
    eng = _storm(mk(num_pages=8, overcommit="prompt"))
    m = eng.run()
    assert m["preemptions"] >= 1 and m["replay_prefill_chunks"] >= 1
    preempted = {u for _, ev, u in eng.events if ev == "preempt"}
    assert preempted and preempted == {u for _, ev, u in eng.events if ev == "readmit"}
    for uid, ref in solo_refs.items():
        assert eng.requests[uid].state == "done"
        assert list(eng.requests[uid].generated) == ref, uid
    assert len(set(map(tuple, solo_refs.values()))) > 1
    eng.assert_no_leaks()
    worst = _storm(mk(num_pages=8, overcommit="none")).run()
    assert m["mean_slot_occupancy"] > worst["mean_slot_occupancy"]


def test_victim_is_lowest_priority_then_newest(mk):
    eng = mk(num_pages=49, overcommit="prompt")
    eng.submit(PROMPTS[0], 4, uid=0, priority=1)
    eng.submit(PROMPTS[1], 4, uid=1, priority=0)
    eng.submit(PROMPTS[2], 4, uid=2, priority=1)
    eng.step()
    assert all(r is not None for r in eng.slot_req)
    assert eng._preempt_for(eng.requests[0])
    assert eng.requests[1].state == "waiting" and eng.requests[1].preemptions == 1
    assert eng._preempt_for(eng.requests[0])
    assert eng.requests[2].state == "waiting"
    assert not eng._preempt_for(eng.requests[0])
    eng.run()
    assert all(eng.requests[u].state == "done" for u in (0, 1, 2))
    eng.assert_no_leaks()


def test_deadlines_while_running_and_waiting(mk):
    eng = mk(num_pages=49)
    eng.submit(PROMPTS[0], 12, uid=0, deadline_ticks=4)
    eng.submit(PROMPTS[1], 6, uid=1)
    m = eng.run()
    assert eng.requests[0].state == "expired" and len(eng.requests[0].generated) < 12
    assert eng.requests[1].state == "done" and m["expired"] == 1
    assert eng.pool.refcount(0) == 0
    eng.assert_no_leaks()
    assert not eng.cancel(0)  # terminal: cancel is a no-op, the uid is reusable
    eng.submit(PROMPTS[0], 2, uid=0)
    eng.run()
    assert eng.requests[0].state == "done"

    eng = mk(num_pages=8, overcommit="none")
    eng.submit(PROMPTS[0], 12, uid=0)
    eng.submit(PROMPTS[1], 12, uid=1, deadline_ticks=2)
    eng.run()
    assert eng.requests[0].state == "done"
    assert eng.requests[1].state == "expired" and eng.requests[1].generated == []
    eng.assert_no_leaks()


def test_reject_reasons_are_typed(mk):
    eng = mk(num_pages=8)
    eng.submit(PROMPTS[0], 4, uid=7)
    cases = [(PROMPTS[1], 4, {"uid": 7}, "duplicate_uid"),
             (PROMPTS[0], 0, {}, "bad_max_new"),
             (np.zeros(30, np.int32), 20, {}, "too_long"),
             (np.zeros(20, np.int32), 10, {}, "exceeds_pool"),
             (PROMPTS[0], 4, {"deadline_ticks": 0}, "bad_deadline")]
    for prompt, mn, kw, reason in cases:
        with pytest.raises(tse.RequestRejected) as ei:
            eng.submit(prompt, mn, **kw)
        assert ei.value.reason == reason
        assert eng.events[-1][1] == f"reject:{reason}"
    assert np.array_equal(eng.requests[7].prompt, PROMPTS[0])  # not overwritten
    eng.run()
    eng.drain()
    with pytest.raises(tse.RequestRejected) as ei:
        eng.submit(PROMPTS[0], 2)
    assert ei.value.reason == "draining"


def test_stall_carries_completed_work(mk):
    eng = mk(num_pages=49)
    eng.submit(PROMPTS[0], 2, uid=0)
    eng.submit(PROMPTS[1], 30 - len(PROMPTS[1]) - 1, uid=1)
    with pytest.raises(tse.EngineStalledError) as ei:
        eng.run(max_ticks=6)
    err = ei.value
    assert err.states[0] == "done" and err.states[1] in ("prefill", "decode")
    assert err.metrics["tokens_generated"] >= 2 and "max_ticks=6" in str(err)
    assert eng.requests[0].generated
    m = eng.run(max_ticks=2, strict=False)
    assert m["stalled"] is True and m["states"][1] in tse.ACTIVE_STATES
    eng.run()
    assert eng.requests[1].state == "done"
    eng.assert_no_leaks()


@pytest.mark.parametrize("finish", [True, False])
def test_drain_modes(mk, finish):
    eng = mk(num_pages=49)
    for uid in range(3):
        eng.submit(PROMPTS[uid], MAX_NEWS[uid], uid=uid)
    for _ in range(6):
        eng.step()
    statuses = eng.drain(finish=finish)
    assert eng.draining
    if finish:
        assert all(s == "done" for s in statuses.values()), statuses
        assert eng.drain(finish=True) == statuses  # idempotent
    else:
        assert set(statuses.values()) <= {"waiting", "done"}
        assert "waiting" in statuses.values()
    eng.assert_no_leaks()


def test_run_with_shutdown_drains(mk):
    eng = mk(num_pages=49)
    for uid in range(3):
        eng.submit(PROMPTS[uid], MAX_NEWS[uid], uid=uid)
    for _ in range(4):
        eng.step()
    gs = GracefulShutdown(install=False)
    gs.requested = True
    m = eng.run(shutdown=gs)
    assert m["drained"] is True and m["draining"] is True
    assert all(s == "done" for s in m["states"].values())
    assert m["stragglers"] == eng._watchdog.stragglers and m["mean_tick_s"] > 0
    eng.assert_no_leaks()


def test_non_finite_logits_fail_one_stream(mk):
    """A NaN logit row fails only that request; the batch goes on."""
    eng = mk(num_pages=49)
    for uid in range(3):
        eng.submit(PROMPTS[uid], MAX_NEWS[uid], uid=uid)
    eng.compile()
    orig = eng._decode_c
    fired = []

    def poisoned(params, tokens, cache, pos, bt):
        logits, cache = orig(params, tokens, cache, pos, bt)
        req = eng.requests[1]
        if not fired and req.state == "decode" and len(req.generated) >= 2:
            logits = logits.clone()  # an inference tensor is read-only outside
            logits[req.slot] = float("nan")
            fired.append(True)
        return logits, cache

    eng._decode_c = poisoned
    m = eng.run()
    assert fired and m["failed"] == 1
    assert eng.requests[1].state == "failed" and eng.requests[1].error
    assert all(eng.requests[u].state == "done" for u in (0, 2))
    eng.assert_no_leaks()
