"""The port's BRECQ calibration against the JAX package, on the CPU.

Reduced brecq-lm-100m (4 layers, d_model 128). Parameters cross with
``interop.params_from_numpy``; batches come from both packages'
token-identical ``make_batches``. Tolerances: the Fisher and one
optimization step (loss, grads w.r.t. ``v`` and the LSQ scales) within
rtol 1e-4; whole ``quantize`` runs — whose minibatches ``jax.random``
draws and torch cannot replay — with ``calib_bs == N``, so that every
minibatch is a permutation of the calibration set and the unit loss, a
mean, does not depend on it: loss traces within rtol 1e-3, hardened
``v >= 0`` on at least 99.9% of weights alike, perplexity within 0.5%.
Artifacts cross both ways; evaluations and logits within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ReconConfig as JReconConfig
from repro.core import quantize as jquantize
from repro.core.adaround import init_v as j_init_v
from repro.core.evaluate import evaluate as jevaluate
from repro.core.fisher import FisherStream as JFisherStream
from repro.core.hooks import AdaRoundHook as JAdaRoundHook
from repro.core.lsq import init_act_scale as j_init_act_scale
from repro.core.reconstruction import Walker as JWalker
from repro.core.reconstruction import enumerate_weights as j_enumerate_weights
from repro.core.reconstruction import init_states as j_init_states
from repro.data import Corpus as JCorpus
from repro.data import CorpusConfig as JCorpusConfig
from repro.data import make_batches as jmake_batches
from repro.deploy import QuantizedArtifact as JArtifact
from repro.models import get_model as j_get_model
from repro_torch.core import ReconConfig, quantize
from repro_torch.core import calib_loop, reconstruction
from repro_torch.core.evaluate import evaluate
from repro_torch.core.fisher import FisherStream, block_grads, model_blocks
from repro_torch.core.quantizer import QState
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.deploy import QuantizedArtifact, export
from repro_torch.interop import flatten_paths, params_from_numpy, params_to_numpy
from repro_torch.models import get_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Calibration is thousands of small ops: beside other test workers on
    the same cores, torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def rand():
    """Randomly initialised reduced brecq-lm-100m in both packages, with 2
    calibration batches of 4 x 32 tokens."""
    cfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1)
    _, model = get_model("brecq_lm_100m", reduced=True)
    params = params_from_numpy(np_tree(jparams), device="cpu")
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1)
    return jmodel, jparams, jcal, model, params, cal


@pytest.fixture(scope="module")
def trained(tiny_trained):
    """The JAX-trained reduced model (tests/conftest.py) in both packages."""
    cfg, jmodel, jparams, jcal, jeval, _ = tiny_trained
    _, model = get_model("brecq_lm_100m", reduced=True)
    conv = lambda bs: [{"tokens": torch.tensor(np.asarray(b["tokens"]), dtype=torch.int64)}
                       for b in bs]  # noqa: E731
    tparams = params_from_numpy(np_tree(jparams), device="cpu")
    return jmodel, jparams, jcal, jeval, model, tparams, conv(jcal), conv(jeval)


def leaf(tree, path):
    parts = path.split("/")
    sname, ri = parts[0].rsplit(".", 1)
    node = tree[sname]
    for k in parts[1:]:
        node = node[k]
    return node["w"][int(ri)]


# ---------------------------------------------------------------------------
# walker, weights, Fisher
# ---------------------------------------------------------------------------


def test_walker_and_weights_match_jax(rand):
    jmodel, jparams, jcal, model, params, cal = rand
    jw = j_enumerate_weights(jmodel, jparams, jcal[0])
    tw = reconstruction.enumerate_weights(model, params, cal[0])
    assert list(tw) == list(jw) and len([p for p in tw if "." in p]) == 4 * 7
    want = np.asarray(JWalker(jmodel).run(jparams, jcal[0]))
    with torch.no_grad():
        got = reconstruction.Walker(model).run(params, cal[0]).numpy()
        fwd = model.forward(params, cal[0])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, fwd)
    rc, jrc = ReconConfig(w_bits=3), JReconConfig(w_bits=3)
    tq, teh = reconstruction.init_states(model, tw, rc)
    jq, jeh = j_init_states(jmodel, jw, jrc)
    assert list(tq) == list(jq) and list(teh) == list(jeh) == ["embed/table"]
    for p in list(jq) + list(jeh):
        (ts, tc), (js, jc) = (tq.get(p) or teh[p]), (jq.get(p) or jeh[p])
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))


@pytest.mark.parametrize("mode", ["full", "stream"])
def test_fisher_matches_jax(rand, mode):
    jmodel, jparams, jcal, model, params, cal = rand
    jf = JFisherStream(JWalker(jmodel), jparams, jcal, mode=mode, dtype=jnp.float32)
    tf = FisherStream(reconstruction.Walker(model), params, cal, mode=mode,
                      dtype=torch.float32)
    for bi in range(4):
        want = np.asarray(jf.for_block(bi))
        got = tf.for_block(bi).numpy()
        assert got.shape == want.shape == (8, 32, 128)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
    assert tf.peak_bytes == jf.peak_bytes
    grads = block_grads(model, params, cal[0])
    assert len(grads) == len(model_blocks(model)) == 4
    g2 = grads[2].to(torch.float32) ** 2
    ref = tf.for_block(2)[:4] * float(
        torch.cat([block_grads(model, params, b)[2] ** 2 for b in cal]).mean())
    np.testing.assert_allclose(g2.numpy(), ref.numpy(), rtol=1e-4, atol=1e-6 * float(g2.max()))


def test_one_step_loss_and_grads_match_jax(rand):
    """The unit loss of one minibatch (a_bits=8, Fisher-weighted, the
    rounding regularizer on) and its grads w.r.t. v and the LSQ scales."""
    jmodel, jparams, jcal, model, params, cal = rand
    rc, jrc = ReconConfig(w_bits=2, a_bits=8, iters=200), JReconConfig(w_bits=2, a_bits=8, iters=200)
    it, bi = 150, 1
    walker, jwalker = reconstruction.Walker(model), JWalker(jmodel)
    tw = reconstruction.enumerate_weights(model, params, cal[0])
    jw = j_enumerate_weights(jmodel, jparams, jcal[0])
    qstates, _ = reconstruction.init_states(model, tw, rc)
    jqstates, _ = j_init_states(jmodel, jw, jrc)
    rng = np.random.default_rng(0)
    batch, jbatch = cal[0], jcal[0]
    with torch.no_grad():
        x, ctx = walker.stem(params, batch)
        for b in range(bi):
            x = walker.apply_block(params, b, x, ctx)
        zt = walker.apply_block(params, bi, x, ctx)
    xin = x + 0.01 * torch.tensor(rng.standard_normal(x.shape), dtype=torch.float32)
    g2 = torch.tensor(rng.uniform(0.1, 2.0, x.shape), dtype=torch.float32)
    unit = [bi]
    canon = reconstruction._unit_canon(walker, unit)
    bparams, stackdefs, _ = reconstruction._unit_pieces(walker, params, unit)
    wpaths = [p for p in tw if p.startswith(walker.block_path(bi) + "/")]
    probe = calib_loop.get_unit_probe(model, walker, stackdefs, False, bparams,
                                      xin[:1], {"tokens": batch["tokens"][:1]}, None)
    acts = probe.acts(bparams, xin[:1], {"tokens": batch["tokens"][:1]}, None)
    v0 = {canon(p): np.asarray(j_init_v(jw[p], *jqstates[p]))
          + rng.normal(0, 0.5, tw[p].shape).astype(np.float32) for p in wpaths}
    s0 = {cp: np.asarray(j_init_act_scale(jnp.asarray(a.numpy()), 8, True)) * 0.8
          for cp, a in acts.items()}
    states = {canon(p): qstates[p][0] for p in wpaths}
    cfgs = {canon(p): qstates[p][1] for p in wpaths}
    progs = calib_loop.get_unit_programs(
        model, walker, stackdefs, False, cfgs, rc, 4, 4, bparams, states,
        {"v": v0, "s": s0}, (xin, xin, g2, batch, None))
    opt = {"v": {k: torch.tensor(v, requires_grad=True) for k, v in v0.items()},
           "s": {k: torch.tensor(s, requires_grad=True) for k, s in s0.items()}}
    loss = progs.loss(opt, states, bparams, xin, zt, g2, batch, None, it)
    loss.backward()

    jstates = {canon(p): (jqstates[p][0], jqstates[p][1]) for p in wpaths}
    jctx = jwalker.ctx_for(jbatch, 0, None)
    jb = jax.tree.map(lambda a: a[bi], jparams["body"])

    def jloss(o):
        hook = JAdaRoundHook(jstates, o, 8, soft=True)
        y, _ = jmodel.apply_block(dataclasses.replace(jctx, quant=hook, scope="u0"),
                                  jmodel.stacks[0], jb, jnp.asarray(xin.numpy()))
        err = (y - jnp.asarray(zt.numpy())) ** 2 * jnp.asarray(g2.numpy())
        beta, en = jrc.beta(jnp.float32(it), jrc.iters)
        from repro.core.adaround import round_reg

        reg = sum(round_reg(v, beta) for v in o["v"].values())
        nelem = sum(v.size for v in o["v"].values())
        return jnp.mean(err) + jrc.lam * en * reg / nelem

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, {"v": v0, "s": s0}))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    assert set(opt["s"]) == set(jg["s"]) and len(opt["s"]) == 7
    for k in ("v", "s"):
        for p, t in opt[k].items():
            want = np.asarray(jg[k][p])
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# whole runs on the trained model
# ---------------------------------------------------------------------------


def test_quantize_trajectories_match_jax(trained):
    jmodel, jparams, jcal, jeval, model, params, cal, evalb = trained
    n = sum(b["tokens"].shape[0] for b in cal)
    kw = dict(w_bits=2, iters=10, calib_bs=n, stream_dtype="float32",
              input_source="quant", use_fisher=True)
    jres = jquantize(jmodel, jparams, jcal, JReconConfig(**kw))
    res = quantize(model, params, cal, ReconConfig(**kw))
    assert res.stats["n_units"] == jres.stats["n_units"] == 4
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["retries"] == ju["retries"] == 0
        np.testing.assert_allclose(tu["loss_trace"], np.asarray(ju["loss_trace"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tu["rtn_recon_mse"], ju["rtn_recon_mse"], rtol=1e-3)
    assert set(res.v) == set(jres.v)
    same = sum(int(((res.v[p] >= 0).numpy() == (np.asarray(jres.v[p]) >= 0)).sum())
               for p in res.v)
    total = sum(v.numel() for v in res.v.values())
    assert same / total >= 0.999, same / total
    jppl = jevaluate(jmodel, jres.params_q, jeval)["ppl"]
    tppl = evaluate(model, res.params_q, evalb)["ppl"]
    assert abs(tppl - jppl) <= 0.005 * jppl, (tppl, jppl)


def test_quality_ordering_at_jax_settings(trained):
    """FP < BRECQ-W2 < RTN-W2, and W4 within 0.05 of FP, at the JAX
    package's own settings (tests/test_reconstruction.py, which holds
    BRECQ-W2 <= RTN-W2 + 1e-3). On this 4-layer model the W2 gap is small
    (about 0.01 nats; the gap widens with depth and iterations)."""
    jmodel, jparams, jcal, jeval, model, params, cal, evalb = trained
    fp = evaluate(model, params, evalb)["loss"]
    w4 = quantize(model, params, cal, ReconConfig(w_bits=4, iters=60, calib_bs=8))
    assert evaluate(model, w4.params_q, evalb)["loss"] <= fp + 0.05
    res = quantize(model, params, cal, ReconConfig(w_bits=2, iters=120, calib_bs=8))
    brecq = evaluate(model, res.params_q, evalb)["loss"]
    qs = {p: s for p, s in res.qstates.items() if p != "embed/table"}
    rtn_params = reconstruction.bake(model, params, qs, {},
                                     {"embed/table": res.qstates["embed/table"]})
    rtn = evaluate(model, rtn_params, evalb)["loss"]
    assert fp < brecq < rtn, (fp, brecq, rtn)


def test_rtn_on_scales_rounds_to_nearest_on_the_calibrated_scales(rand):
    """The RTN baseline beside BRECQ: every block weight rounded to nearest
    on its calibrated scale (AdaRound's logits at their RTN start differ
    from round-to-nearest only at ties, within float error of a half
    step), the embedding as ``res`` quantized it, ``params`` untouched."""
    from repro_torch.core import rtn_on_scales
    from repro_torch.core.quantizer import quantize_dequant

    _, _, _, model, params, cal = rand
    before = {k: t.clone() for k, t in flatten_paths(params).items()}
    res = quantize(model, params, cal, _rc(w_bits=2, iters=2))
    rtn = rtn_on_scales(model, params, res, cal[0])
    blocks = [p for p in res.qstates if "." in p.split("/")[0]]
    assert blocks and "embed/table" in res.qstates
    for p in blocks:
        st, qcfg = res.qstates[p]
        got, want = leaf(rtn, p), quantize_dequant(leaf(params, p), st, qcfg)
        differ = got != want
        assert float(differ.float().mean()) < 1e-3, p
        assert float((got - want).abs().max()) <= 1.0001 * float(st.scale.max()), p
    assert torch.equal(rtn["embed"]["table"], res.params_q["embed"]["table"])
    for k, t in flatten_paths(params).items():
        assert torch.equal(t, before[k]), k


# ---------------------------------------------------------------------------
# modes, guards, journal
# ---------------------------------------------------------------------------


def _rc(**kw):
    base = dict(w_bits=3, iters=6, calib_bs=4, stream_dtype="float32")
    base.update(kw)
    return ReconConfig(**base)


@pytest.mark.parametrize("granularity,units", [("layer", 4), ("stage", 4), ("net", 1)])
def test_granularities_run(rand, granularity, units):
    _, _, _, model, params, cal = rand
    res = quantize(model, params, cal, _rc(granularity=granularity, a_bits=8))
    assert res.stats["n_units"] == units
    assert len(res.v) == 28 and len(res.act_scales) == 28
    assert np.isfinite(evaluate(model, res.params_q, cal, res.act_scales, 8)["loss"])
    if granularity == "layer":
        assert res.stats["layer_cache"]["misses"] >= 1
        assert res.stats["cap_cache"]["hits"] >= 1


def test_scan_equals_python_bit_for_bit(rand):
    _, _, _, model, params, cal = rand
    a = quantize(model, params, cal, _rc(loop_impl="scan", stream_dtype="bfloat16"))
    b = quantize(model, params, cal, _rc(loop_impl="python", stream_dtype="bfloat16"))
    for ua, ub in zip(a.stats["units"], b.stats["units"]):
        np.testing.assert_array_equal(ua["loss_trace"].astype(np.float64), ub["loss_trace"])
    for p in a.v:
        assert torch.equal(a.v[p], b.v[p])
    assert a.stats["unit_cache"] == {"hits": 3, "misses": 1}
    assert a.stats["calib_peak_bytes_detail"]["fisher"] == 8 * 32 * 128 * 2


def test_journal_resume_is_bit_identical(rand, tmp_path, monkeypatch):
    from repro_torch.core import CalibrationInterrupted

    _, _, _, model, params, cal = rand
    rc = _rc(stream_dtype="bfloat16")
    ref = quantize(model, params, cal, rc)

    class StopAfterFirst:
        def __init__(self):
            self.requested = True

        def restore(self):
            pass

    monkeypatch.setattr(reconstruction, "GracefulShutdown", StopAfterFirst)
    with pytest.raises(CalibrationInterrupted) as e:
        quantize(model, params, cal, rc, workdir=str(tmp_path))
    assert e.value.next_unit == 1
    monkeypatch.undo()
    res = quantize(model, params, cal, rc, workdir=str(tmp_path))
    assert res.stats["resumed_at_unit"] == 1
    for p in ref.v:
        assert torch.equal(res.v[p], ref.v[p])
    for a, b in zip(jax.tree.leaves(params_to_numpy(res.params_q)),
                    jax.tree.leaves(params_to_numpy(ref.params_q))):
        np.testing.assert_array_equal(a, b)
    from repro_torch.core import CalibJournalError

    with pytest.raises(CalibJournalError, match="different"):
        quantize(model, params, cal, _rc(w_bits=4), workdir=str(tmp_path))


def _patched_loop(monkeypatch, bad, exc=None):
    orig = calib_loop.run_unit_loop
    calls = {"n": 0, "bs": []}

    def patched(progs, rc, bparams, states, opt, ostate, gen, x_q, *a, **k):
        i = calls["n"]
        calls["n"] += 1
        if i in bad and exc is not None:
            raise exc
        opt, losses = orig(progs, rc, bparams, states, opt, ostate, gen, x_q, *a, **k)
        if i in bad:
            opt = {"v": {p: torch.full_like(v, float("nan")) for p, v in opt["v"].items()},
                   "s": opt["s"]}
            losses = np.full_like(losses, np.nan)
        return opt, losses

    monkeypatch.setattr(calib_loop, "run_unit_loop", patched)
    return calls


def test_guard_retries_then_recovers(rand, monkeypatch):
    _, _, _, model, params, cal = rand
    _patched_loop(monkeypatch, {0})
    res = quantize(model, params, cal, _rc(unit_retries=2))
    u0 = res.stats["units"][0]
    assert res.stats["unit_retries"] == 1 and res.stats["unit_fallbacks"] == 0
    assert u0["retries"] == 1 and not u0["fallback"]
    assert u0["final_recon_mse"] <= u0["rtn_recon_mse"] * 1.5
    assert all(bool(torch.isfinite(t).all())
               for t in jax.tree.leaves(res.params_q, is_leaf=torch.is_tensor))


def test_guard_falls_back_to_rtn(rand, monkeypatch):
    from repro_torch.core.quantizer import quantize_dequant

    _, _, _, model, params, cal = rand
    _patched_loop(monkeypatch, {0, 1})
    res = quantize(model, params, cal, _rc(unit_retries=1))
    u0 = res.stats["units"][0]
    assert res.stats["unit_fallbacks"] == 1 and u0["fallback"] and u0["retries"] == 1
    assert u0["final_recon_mse"] == u0["rtn_recon_mse"]
    assert not any(p.startswith("body.0/") for p in res.v)
    assert sum(p.startswith("body.1/") for p in res.v) == 7
    st, qc = res.qstates["body.0/sub0/attn/wq"]
    assert torch.equal(leaf(res.params_q, "body.0/sub0/attn/wq"),
                       quantize_dequant(leaf(params, "body.0/sub0/attn/wq"), st, qc))


def test_guard_halves_minibatch_on_cuda_oom(rand, monkeypatch):
    _, _, _, model, params, cal = rand
    _patched_loop(monkeypatch, {0}, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    res = quantize(model, params, cal, _rc())
    u0 = res.stats["units"][0]
    assert u0["oom_halvings"] == 1 and u0["calib_bs"] == 2
    assert res.stats["unit_oom_halvings"] == 1 and res.stats["units"][1]["calib_bs"] == 4
    monkeypatch.undo()
    _patched_loop(monkeypatch, {0}, RuntimeError("an error that says OOM"))
    with pytest.raises(RuntimeError, match="OOM"):
        quantize(model, params, cal, _rc())


# ---------------------------------------------------------------------------
# MoE calibration (multi-stack units, stacked (E, K, N) expert weights)
# ---------------------------------------------------------------------------

MOE_KW = dict(w_bits=2, iters=6, calib_bs=8, stream_dtype="float32", use_fisher=True)


def moe_pair(arch, impl):
    """Reduced MoE model in both packages, the same random weights, and 2
    calibration batches of 4 x 16 tokens (N = 8 = calib_bs)."""
    cfg, jmodel = j_get_model(arch, reduced=True, moe_impl=impl)
    _, model = get_model(arch, reduced=True, moe_impl=impl)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1)
    params = params_from_numpy(np_tree(jparams), device="cpu")
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1)
    return cfg, jmodel, jparams, jcal, model, params, cal


@pytest.fixture(scope="module", params=[
    ("deepseek_moe_16b", "dense"), ("deepseek_moe_16b", "capacity"),
    ("qwen3_moe_235b_a22b", "dense"), ("qwen3_moe_235b_a22b", "capacity")],
    ids=lambda p: "-".join(p))
def moe_runs(request):
    """One W2 ``quantize`` per (config, routing) in both packages,
    ``calib_bs == N`` and f32 streams (so minibatches do not matter)."""
    cfg, jmodel, jparams, jcal, model, params, cal = moe_pair(*request.param)
    jres = jquantize(jmodel, jparams, jcal, JReconConfig(**MOE_KW))
    res = quantize(model, params, cal, ReconConfig(**MOE_KW))
    return cfg, jmodel, model, res, jres


def test_moe_quantize_matches_jax(moe_runs):
    cfg, _, _, res, jres = moe_runs
    n_units = cfg.n_layers
    assert res.stats["n_units"] == jres.stats["n_units"] == n_units
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["retries"] == ju["retries"] == 0
        np.testing.assert_allclose(tu["loss_trace"], np.asarray(ju["loss_trace"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tu["rtn_recon_mse"], ju["rtn_recon_mse"], rtol=1e-3)
    assert set(res.v) == set(jres.v)
    experts = [p for p in res.v if res.v[p].ndim == 3]
    assert experts and all(p.startswith("moe.") for p in experts)
    same = sum(int(((res.v[p] >= 0).numpy() == (np.asarray(jres.v[p]) >= 0)).sum())
               for p in res.v)
    total = sum(v.numel() for v in res.v.values())
    assert same / total >= 0.999, same / total
    for p in experts:  # expert scales are shared across experts, as in JAX
        st, _ = res.qstates[p]
        assert st.scale.shape == (1, 1, res.v[p].shape[-1])
        np.testing.assert_allclose(st.scale.numpy(), np.asarray(jres.qstates[p][0].scale),
                                   rtol=1e-6)


def test_moe_export_loads_in_jax(moe_runs, tmp_path):
    from repro.deploy import export as jexport

    _, jmodel, model, res, jres = moe_runs
    art = export(model, res)
    art.save(str(tmp_path))
    jart = JArtifact.load(str(tmp_path))  # verifies schema, crc32, digest
    want = jexport(jmodel, jres)
    assert jart.manifest["bits_by_path"] == want.manifest["bits_by_path"]
    got_leaves = jax.tree_util.tree_flatten_with_path(jart.params)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want.params)[0]
    assert [(k, a.shape, a.dtype) for k, a in got_leaves] == \
        [(k, a.shape, a.dtype) for k, a in want_leaves]
    assert jart.nbytes() == want.nbytes()
    # the calibrated experts' scales are shared, (1, 1, N) a layer: the
    # packed forward equals JAX's forward on the baked weights, and so does
    # a decode step (<= 8 rows an expert, the decode tier). (JAX's own
    # packed path scans experts and scales together at <= 8 rows, and
    # rejects a scale shared by the experts.)
    tart = QuantizedArtifact.load(str(tmp_path))
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 8))
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        got = model.forward(tart.params, batch, tart.hook())[0]
        logits = []
        for params in (tart.params, res.params_q):
            cache = model.init_cache(2, 9, torch.float32, "cpu")
            _, cache = model.prefill(params, batch, cache, tart.hook())
            logits.append(model.decode_step(params, batch["tokens"][:, -1:], cache,
                                            torch.full((2,), 8, dtype=torch.int32),
                                            tart.hook())[0])
    ref = np.asarray(jmodel.forward(np_tree(params_to_numpy(res.params_q)),
                                    {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(), rtol=1e-4,
                               atol=1e-4 * float(logits[1].abs().max()))


def test_moe_per_layer_bits_export_matches_jax(tmp_path):
    """Mixed bits across a MoE model's layers: the port's export promotes
    each stack to its widest layer's container, and the JAX package's
    export of the same calibration gives the same artifact, digest
    included."""
    from repro.core.quantizer import QConfig as JQConfig
    from repro.core.quantizer import QState as JQState
    from repro.core.reconstruction import PTQResult as JPTQResult
    from repro.deploy import export as jexport

    cfg, jmodel, _, _, model, params, cal = moe_pair("deepseek_moe_16b", "dense")
    paths = [p for p in reconstruction.enumerate_weights(model, params, cal[0])
             if "." in p.split("/")[0]]
    rng = np.random.default_rng(3)
    bits = {p: int(rng.choice([2, 4, 8])) for p in paths}
    res = quantize(model, params, cal, ReconConfig(**{**MOE_KW, "per_layer_bits": bits}))
    assert {p: res.qstates[p][1].bits for p in paths} == bits
    art = export(model, res)
    art.save(str(tmp_path))
    jart = JArtifact.load(str(tmp_path))
    got = jart.manifest["bits_by_path"]
    assert {p: got[p] for p in paths} == bits
    assert {p: b for p, b in got.items() if p not in bits} == {"embed/table": 8, "head/w": 8}
    jres = JPTQResult(
        params_q=np_tree(params_to_numpy(res.params_q)), act_scales={},
        qstates={p: (JQState(jnp.asarray(st.scale.numpy()), jnp.asarray(st.zero_point.numpy())),
                     JQConfig(**dataclasses.asdict(qc)))
                 for p, (st, qc) in res.qstates.items()},
        v={p: jnp.asarray(v.numpy()) for p, v in res.v.items()}, stats={})
    want = jexport(jmodel, jres)
    want.save(str(tmp_path / "jax"))
    assert want.manifest["bits_by_path"] == jart.manifest["bits_by_path"]
    assert want.manifest["content_digest"] == jart.manifest["content_digest"]
    for key in ("moe", "dense0"):  # stacks promoted to their widest layer
        node = jart.params[key]["sub0"]["attn"]["wq"]
        widest = max(b for p, b in bits.items() if p.startswith(f"{key}.")
                     and p.endswith("/attn/wq"))
        assert node["w"].shape[-2] == cfg.d_model * widest // 8


# ---------------------------------------------------------------------------
# artifacts both ways
# ---------------------------------------------------------------------------


def test_port_export_loads_in_jax_and_evaluates_alike(rand, tmp_path):
    jmodel, jparams, jcal, model, params, cal = rand
    res = quantize(model, params, cal, _rc(w_bits=2))
    art = export(model, res)
    art.save(str(tmp_path))
    jart = JArtifact.load(str(tmp_path))  # verifies schema, crc32, digest
    tart = QuantizedArtifact.load(str(tmp_path))
    assert jart.manifest["bits_by_path"] == art.manifest["bits_by_path"]
    # the artifact's dequantized block weights are params_q, bit for bit
    from repro_torch.deploy import dequant_leaf

    for p, (st, qc) in res.qstates.items():
        if "." not in p:
            continue
        parts = p.split("/")
        node = tart.params[parts[0].rsplit(".", 1)[0]]
        for k in parts[1:]:
            node = node[k]
        ri = int(parts[0].rsplit(".", 1)[1])
        want = leaf(res.params_q, p)
        w = dequant_leaf(node["w"][ri], node["qscale"][ri], want.shape[0])
        assert torch.equal(w, want), p
    want = jevaluate(jmodel, jart, jcal)
    got = evaluate(model, tart, cal)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(evaluate(model, res.params_q, cal)["loss"], want["loss"],
                               rtol=1e-4)


def test_w4a8_artifact_serves_through_serve_hook_like_jax(rand, tmp_path):
    from repro.core.reconstruction import Walker as JW
    from repro_torch.core.hooks import ServeHook

    jmodel, jparams, jcal, model, params, cal = rand
    res = quantize(model, params, cal, _rc(w_bits=4, a_bits=8))
    art = export(model, res)
    assert art.manifest["a_bits"] == 8 and len(art.act_scales) == 28
    art.save(str(tmp_path))
    tart = QuantizedArtifact.load(str(tmp_path))
    jart = JArtifact.load(str(tmp_path))
    assert isinstance(tart.hook(), ServeHook)
    with torch.no_grad():
        got = reconstruction.Walker(model).run(tart.params, cal[0], tart.hook()).numpy()
        no_act = reconstruction.Walker(model).run(tart.params, cal[0]).numpy()
    want = np.asarray(JW(jmodel).run(jart.params, jcal[0], jart.hook()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert np.abs(got - no_act).max() > 1e-4 * np.abs(want).max()
