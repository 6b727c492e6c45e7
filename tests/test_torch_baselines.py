"""The port's PTQ baselines (``repro_torch.core.baselines``) against the
JAX package's ``repro.core.baselines``, on the CPU.

Random-init reduced brecq-lm-100m cut to 2 layers (1 for AdaQuant, whose
JAX loop compiles four programs a layer, and LAPQ, whose every probe is an
eager JAX forward), 2 calibration batches of 4 x 32 tokens; params cross with ``interop.params_from_numpy``. Each JAX result
is computed once (module-scoped caches). Tolerances: baked leaves within
1e-6 * max|leaf| (bias leaves 1e-5 * max|b| + 1e-7), act scales 1e-6
relative, eval losses 1e-4 relative; AdaQuant's ``dw`` as stated at
``test_adaquant_matches_jax``.

JAX's bias correction installs no bias: its hook takes the correction in
``weight``, which a linear calls before ``act`` hands it the input
(ROADMAP §3.9). The port is held against the JAX loop run eagerly with
that hook's correction taken in ``act`` instead.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core.evaluate import evaluate as jevaluate
from repro.data import Corpus as JCorpus
from repro.data import CorpusConfig as JCorpusConfig
from repro.data import arch_extras_fn as j_arch_extras_fn
from repro.data import make_batches as jmake_batches
from repro.models import build_model as j_build_model
from repro.models import get_config as j_get_config
from repro_torch.core import baselines
from repro_torch.core.evaluate import evaluate
from repro_torch.core.quantizer import quantize_dequant
from repro_torch.core.reconstruction import ReconConfig, enumerate_weights, init_states
from repro_torch.data import Corpus, CorpusConfig, arch_extras_fn, make_batches
from repro_torch.interop import flatten_paths, params_from_numpy, params_to_numpy
from repro_torch.models import build_model, get_config
from test_torch_families import np_params
from torch_threads import one_torch_thread  # noqa: F401

W_BITS = 2
ADA = dict(iters=3, calib_bs=4, lr=1e-3)  # N = 8 sequences: rng.choice draws 4
LAPQ_RATIOS = (0.7, 1.0)


def _pair(arch: str, n_layers: int, params_fn):
    """(JAX model, JAX params, JAX batches, model, params, batches) of
    ``arch``'s reduced config cut to ``n_layers``."""
    jcfg = dataclasses.replace(j_get_config(arch, reduced=True), n_layers=n_layers)
    cfg = dataclasses.replace(get_config(arch, reduced=True), n_layers=n_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    p = params_fn(jmodel)
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1,
                         extras_fn=j_arch_extras_fn(jcfg))
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1,
                       extras_fn=arch_extras_fn(cfg))
    return (jmodel, jax.tree.map(jnp.asarray, p), jcal, model,
            params_from_numpy(p, device="cpu"), cal)


def _jax_init(jmodel):
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def dense():
    return _pair("brecq_lm_100m", 2, _jax_init)


@pytest.fixture(scope="module")
def one_layer():
    return _pair("brecq_lm_100m", 1, _jax_init)


@pytest.fixture(scope="module")
def whisper():
    """whisper-small reduced to one encoder and one decoder layer, every
    cross-attention gate at 1.0 (JAX's 0 hides the encoder)."""
    return _pair("whisper_small", 1, np_params)


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX baseline result, computed on first use."""
    return {}


def _once(cache: dict, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_paths(tree).items()}


def assert_leaves_close(got, want, tol=1e-6, keys=None):
    got, want = _flat(params_to_numpy(got)), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in keys or want:
        amax = float(np.max(np.abs(want[k]))) if want[k].size else 0.0
        err = float(np.max(np.abs(got[k] - want[k]))) if want[k].size else 0.0
        assert err <= tol * amax, (k, err, amax)


def assert_scales_close(got: dict, want: dict, rtol=1e-6):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# RTN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_bits", [None, 4])
@pytest.mark.parametrize("scale_method,w_group", [("minmax", None), ("mse", 32)])
def test_rtn_matches_jax(dense, jax_runs, scale_method, w_group, a_bits):
    """Each scale method and each scale layout once (every JAX run compiles
    its new ops eagerly: a few seconds each). ``a_bits`` does not enter the
    baked weights (only the act scales), so one JAX run at ``a_bits=4``
    serves both cases."""
    jmodel, jp, jcal, model, tp, cal = dense
    kw = dict(scale_method=scale_method, w_group=w_group)
    jpq, js = _once(jax_runs, ("rtn", scale_method, w_group),
                    lambda: jbaselines.quantize_rtn(jmodel, jp, jcal, W_BITS, a_bits=4, **kw))
    pq, s = baselines.quantize_rtn(model, tp, cal, W_BITS, a_bits=a_bits, **kw)
    assert_leaves_close(pq, jpq)
    if a_bits is None:
        assert s == {}
    else:
        assert_scales_close(s, js)
    # the FP params are not written
    assert torch.equal(tp["embed"]["table"], params_from_numpy(
        np.asarray(jp["embed"]["table"]), device="cpu"))


# ---------------------------------------------------------------------------
# Bias correction
# ---------------------------------------------------------------------------


class _JBiasCorrInOrder(jbaselines._BiasCorrHook):
    """JAX's hook with the correction taken when ``act`` brings the input
    (a linear calls ``weight`` first)."""

    def __init__(self, qstates, existing):
        super().__init__(qstates, existing)
        self._err = {}

    def weight(self, path, w):
        wq = super().weight(path, w)
        if path in self.qstates and w.ndim == 2:
            self._err[path] = (w - wq).astype(jnp.float32)
        return wq

    def act(self, path, x):
        err = self._err.pop(path, None)
        if err is not None:
            xm = jnp.mean(x.reshape(-1, x.shape[-1]).astype(jnp.float32), axis=0)
            self.new_corr[path] = xm @ err
        return x


def jax_bias_correction(jmodel, jp, jcal):
    """JAX's ``quantize_bias_correction`` with the hook above. The loop
    jits each block with the block's hook as the lambda's default
    argument; the corrections the hook records there would be tracers, so
    each block's program here also returns them, and the hook gets their
    values back."""

    def jit(f):
        hook = f.__defaults__[0]

        def run(*args):
            out, corr = jax.jit(lambda *a: (f(*a), dict(hook.new_corr)))(*args)
            hook.new_corr = corr
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbaselines, "_BiasCorrHook", _JBiasCorrInOrder)
        mp.setattr(jbaselines, "jax", types.SimpleNamespace(jit=jit))
        return jbaselines.quantize_bias_correction(jmodel, jp, jcal, W_BITS)


def _bias_paths(tree) -> list:
    return sorted(k for k in flatten_paths(tree) if k.endswith("/b"))


@pytest.mark.parametrize("which", ["dense", "whisper"])
def test_bias_correction_matches_jax(request, jax_runs, which):
    jmodel, jp, jcal, model, tp, cal = request.getfixturevalue(which)
    jpq, _ = _once(jax_runs, ("biascorr", which),
                   lambda: jax_bias_correction(jmodel, jp, jcal))
    pq, s = baselines.quantize_bias_correction(model, tp, cal, W_BITS)
    assert s == {}
    got, want = _flat(params_to_numpy(pq)), _flat(jax.tree.map(np.asarray, jpq))
    new_b = sorted(set(_bias_paths(pq)) - set(_bias_paths(tp)))
    # every stacked linear got a bias; each layer's row is nonzero
    n_linears = 7 if which == "dense" else 6 + 10
    assert len(new_b) == n_linears, new_b
    for k in new_b:
        assert np.all(np.abs(got[k]).max(axis=-1) > 0), k
        tol = 1e-5 * float(np.max(np.abs(want[k]))) + 1e-7
        assert float(np.max(np.abs(got[k] - want[k]))) <= tol, k
    assert_leaves_close(pq, jpq, keys=[k for k in want if k not in new_b])


def test_reference_bias_correction_installs_no_bias(dense, jax_runs):
    """ROADMAP §3.9: as shipped, JAX's bias correction is min-max RTN."""
    jmodel, jp, jcal, _, _, _ = dense
    jpq, _ = jbaselines.quantize_bias_correction(jmodel, jp, jcal, W_BITS)
    jrtn, _ = _once(jax_runs, ("rtn", "minmax", None),
                    lambda: jbaselines.quantize_rtn(jmodel, jp, jcal, W_BITS, a_bits=4,
                                                    scale_method="minmax"))
    a, b = _flat(jax.tree.map(np.asarray, jpq)), _flat(jax.tree.map(np.asarray, jrtn))
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# AdaQuant
# ---------------------------------------------------------------------------


class _Draws:
    """``np.random.Generator`` that records every ``choice``."""

    def __init__(self, seed, log):
        self._rng = np.random.default_rng(seed)
        self._log = log

    def choice(self, *a, **k):
        out = self._rng.choice(*a, **k)
        self._log.append(np.array(out))
        return out


def _recording_numpy(log):
    return types.SimpleNamespace(
        random=types.SimpleNamespace(default_rng=lambda seed: _Draws(seed, log)))


def run_adaquant(mod, model, params, cal, a_bits):
    """``mod.quantize_adaquant`` with its minibatch draws and its trained
    ``dw`` (as handed to ``_bake_deltas``) recorded."""
    draws, deltas = [], {}
    bake = mod._bake_deltas

    def spy(model, params_q, adj):
        deltas.update({p: np.asarray(d) for p, (_, d) in adj.items()})
        return bake(model, params_q, adj)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "np", _recording_numpy(draws))
        mp.setattr(mod, "_bake_deltas", spy)
        pq, s = mod.quantize_adaquant(model, params, cal, W_BITS, a_bits=a_bits, **ADA)
    return pq, s, draws, deltas


@pytest.mark.parametrize("a_bits", [None, 4])
def test_adaquant_matches_jax(one_layer, jax_runs, a_bits):
    """Adam's first steps move ``dw`` by about lr * sign(g), so an element
    whose STE rounding sits at a boundary can take the other step in one
    package: ``dw`` agrees within 1e-4 * max|dw| + 1e-7, except at most
    0.1% of elements, which agree within 2 * lr * iters."""
    jmodel, jp, jcal, model, tp, cal = one_layer
    jpq, js, jdraws, jdeltas = _once(
        jax_runs, ("adaquant", a_bits),
        lambda: run_adaquant(jbaselines, jmodel, jp, jcal, a_bits))
    pq, s, draws, deltas = run_adaquant(baselines, model, tp, cal, a_bits)

    assert len(draws) == len(jdraws) == 7 * ADA["iters"]
    assert all(np.array_equal(a, b) for a, b in zip(draws, jdraws))
    assert list(deltas) == list(jdeltas)
    for p in jdeltas:
        got, want = deltas[p], jdeltas[p]
        err = np.abs(got - want)
        tol = 1e-4 * float(np.max(np.abs(want))) + 1e-7
        assert np.mean(err > tol) <= 1e-3, (p, np.mean(err > tol))
        assert float(err.max()) <= 2 * ADA["lr"] * ADA["iters"], p
    if a_bits is None:
        assert s == {} and js == {}
    else:
        assert_scales_close(s, js)
    ebatch = cal[:1]
    want = jevaluate(jmodel, jpq, jcal[:1], js or None, a_bits)["loss"]
    got = evaluate(model, pq, ebatch, s or None, a_bits)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# LAPQ
# ---------------------------------------------------------------------------


def _chosen_ratios(model, tp, cal, pq) -> dict:
    """Each block path's clip ratio, read back from its baked weights."""
    rc = ReconConfig(w_bits=W_BITS, scale_method="minmax")
    weights = enumerate_weights(model, tp, {k: v[:1] for k, v in cal[0].items()})
    qstates, _ = init_states(model, weights, rc)
    baked = enumerate_weights(model, pq, {k: v[:1] for k, v in cal[0].items()})
    out = {}
    for p, (st, qc) in qstates.items():
        hits = [r for r in LAPQ_RATIOS if torch.equal(
            quantize_dequant(weights[p], dataclasses.replace(st, scale=st.scale * r), qc),
            baked[p])]
        assert len(hits) == 1, (p, hits)
        out[p] = hits[0]
    return out


def test_lapq_matches_jax(one_layer):
    jmodel, jp, jcal, model, tp, cal = one_layer
    jpq, js = jbaselines.quantize_lapq(jmodel, jp, jcal, W_BITS, ratios=LAPQ_RATIOS)
    pq, s = baselines.quantize_lapq(model, tp, cal, W_BITS, ratios=LAPQ_RATIOS)
    assert s == {} and js == {}
    want = _chosen_ratios(model, tp, cal, params_from_numpy(
        jax.tree.map(np.asarray, jpq), device="cpu"))
    got = _chosen_ratios(model, tp, cal, pq)
    assert got == want
    assert set(want.values()) == set(LAPQ_RATIOS)  # the search did choose
    assert_leaves_close(pq, jpq)
