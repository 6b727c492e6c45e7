"""Port parity: the xLSTM mixers (``repro_torch.models.xlstm``) against the
JAX package, on the CPU.

On numpy-made params and inputs, within 1e-5: ``mlstm_apply`` with chunks
of 8 over 24 tokens (the state crosses two chunk boundaries) and in one
chunk; ``mlstm_decode`` and ``slstm_decode`` stepping from the prompt's
state, each package on its own state; ``slstm_apply``; the prefill's state
against JAX's rebuild (``transformer._xlstm_prefill``: a second chunk scan
for mLSTM, a sequential scan over the gates for sLSTM); and a sequence
that is not a whole number of chunks raises, where JAX asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jx
from repro.models.common import Ctx as JCtx
from repro.models.transformer import _xlstm_prefill as j_xlstm_prefill
from repro_torch.interop import params_from_numpy
from repro_torch.models import xlstm
from repro_torch.models.common import Ctx
from torch_threads import one_torch_thread  # noqa: F401


TOL = 1e-5
SPEC = dict(d_model=32, n_heads=2, expansion=2.0, chunk=8)
MIXERS = ["mlstm", "slstm"]


def specs(**over):
    kw = dict(SPEC, **over)
    return jx.XLSTMSpec(**kw), xlstm.XLSTMSpec(**kw)


def np_params(mixer, seed=0):
    """Params of the JAX init's layout made with numpy: linear weights
    uniform in +-1/sqrt(fan_in), norms near 1."""
    jspec, _ = specs()
    init = jx.mlstm_init if mixer == "mlstm" else jx.slstm_init
    shapes = jax.eval_shape(lambda k: init(k, jspec), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "g":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        lim = 1.0 / np.sqrt(s.shape[-2])
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def ctxs(B, S):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return (JCtx(cfg=None, positions=jnp.asarray(pos)),
            Ctx(cfg=None, positions=torch.from_numpy(pos.copy())))


def inputs(S, seed=1, B=2):
    return np.random.default_rng(seed).standard_normal((B, S, SPEC["d_model"])).astype(
        np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mixer", MIXERS)
def test_init_layout_matches_jax(mixer):
    jspec, spec = specs()
    jinit, init = ((jx.mlstm_init, xlstm.mlstm_init) if mixer == "mlstm"
                   else (jx.slstm_init, xlstm.slstm_init))
    got = init(torch.Generator().manual_seed(0), spec)
    want = jinit(jax.random.PRNGKey(0), jspec)
    shapes = lambda t: {"/".join(k.key for k in p): tuple(v.shape)
                        for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(got) == shapes(want)


@pytest.mark.parametrize("S,chunk", [(24, 8), (16, 256), (7, 256)])
def test_mlstm_apply_matches_jax(S, chunk):
    """chunk 8 over 24 tokens: three chunks, the state carried twice; then
    one chunk of the whole sequence, at an odd length."""
    p, x = np_params("mlstm"), inputs(S)
    jspec, spec = specs(chunk=chunk)
    jc, tc = ctxs(2, S)
    want = jx.mlstm_apply(jc, jax.tree.map(jnp.asarray, p), jspec, jnp.asarray(x))
    got = xlstm.mlstm_apply(tc, params_from_numpy(p, device="cpu"), spec, torch.from_numpy(x))
    close(got, want)


def test_slstm_apply_matches_jax():
    p, x = np_params("slstm"), inputs(21)
    jspec, spec = specs()
    jc, tc = ctxs(2, 21)
    want = jx.slstm_apply(jc, jax.tree.map(jnp.asarray, p), jspec, jnp.asarray(x))
    got = xlstm.slstm_apply(tc, params_from_numpy(p, device="cpu"), spec, torch.from_numpy(x))
    close(got, want)


def prefill_both(mixer, S, seed=0):
    p, x = np_params(mixer, seed), inputs(S, seed + 1)
    jspec, spec = specs()
    jc, tc = ctxs(2, S)
    jinit = jx.mlstm_init_cache if mixer == "mlstm" else jx.slstm_init_cache
    jout, jst = j_xlstm_prefill(jc, mixer, jax.tree.map(jnp.asarray, p), jspec,
                                jnp.asarray(x), jinit(jspec, 2))
    fn = xlstm.mlstm_prefill if mixer == "mlstm" else xlstm.slstm_prefill
    out, st = fn(tc, params_from_numpy(p, device="cpu"), spec, torch.from_numpy(x))
    return p, (out, st), (jout, jst)


@pytest.mark.parametrize("mixer", MIXERS)
def test_prefill_state_matches_jax_rebuild(mixer):
    """24 tokens in chunks of 8; JAX rebuilds the state in a second pass (a
    sequential scan for sLSTM), the port keeps the forward's own."""
    _, (out, st), (jout, jst) = prefill_both(mixer, 24)
    close(out, jout)
    assert set(st) == set(jst)
    for k in st:
        assert tuple(st[k].shape) == tuple(jst[k].shape), k
        close(st[k], jst[k])


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_steps_match_jax(mixer):
    """Four steps from the prompt's state, each package on its own state:
    the C, n, m (mLSTM) and c, n, m (sLSTM) each step writes."""
    p, (_, st), (_, jst) = prefill_both(mixer, 16, seed=2)
    jspec, spec = specs()
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")
    jfn, fn = ((jx.mlstm_decode, xlstm.mlstm_decode) if mixer == "mlstm"
               else (jx.slstm_decode, xlstm.slstm_decode))
    for i in range(4):
        xt = inputs(1, 10 + i)
        jc, tc = ctxs(2, 1)
        jy, jst = jfn(jc, jp, jspec, jnp.asarray(xt), jst)
        y, st = fn(tc, tp, spec, torch.from_numpy(xt), st)
        close(y, jy)
        for k in st:
            close(st[k], jst[k])


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_continues_the_parallel_form(mixer):
    """The parallel forward over 24 tokens equals prefill of 16, then eight
    decode steps."""
    p, x = params_from_numpy(np_params(mixer, 5), device="cpu"), torch.from_numpy(inputs(24, 6))
    _, spec = specs()
    apply = xlstm.mlstm_apply if mixer == "mlstm" else xlstm.slstm_apply
    prefill = xlstm.mlstm_prefill if mixer == "mlstm" else xlstm.slstm_prefill
    decode = xlstm.mlstm_decode if mixer == "mlstm" else xlstm.slstm_decode
    full = apply(ctxs(2, 24)[1], p, spec, x)
    _, st = prefill(ctxs(2, 16)[1], p, spec, x[:, :16])
    for t in range(16, 24):
        y, st = decode(ctxs(2, 1)[1], p, spec, x[:, t:t + 1], st)
        close(y[:, 0], full[:, t], 1e-4)


def test_mlstm_rejects_a_ragged_last_chunk():
    p = params_from_numpy(np_params("mlstm"), device="cpu")
    _, spec = specs()
    with pytest.raises(ValueError, match=r"S=20 tokens: not a whole number of chunks of 8"):
        xlstm.mlstm_apply(ctxs(2, 20)[1], p, spec, torch.from_numpy(inputs(20)))
    with pytest.raises(AssertionError):
        jx.mlstm_apply(ctxs(2, 20)[0], jax.tree.map(jnp.asarray, np_params("mlstm")),
                       specs()[0], jnp.asarray(inputs(20)))
