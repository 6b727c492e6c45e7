"""Port parity: ``repro_torch.models.common.associative_scan`` and the
selective SSM (``repro_torch.models.ssm``) against the JAX package, on the
CPU.

The scan follows ``jax.lax.associative_scan``'s odd/even recursion, so the
operands meet in JAX's order: against eager JAX it agrees within 1e-6
relative (ulp level; identical in practice) for the linear recurrence and
the max-plus compose, at odd and even lengths. The SSM's ``_conv_causal``,
``apply``, ``decode`` and the prefill's final state (JAX's
``transformer._ssm_prefill``) agree within 1e-5 on numpy-made params and
inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.common import Ctx as JCtx
from repro.models.transformer import _ssm_prefill as j_ssm_prefill
from repro_torch.interop import params_from_numpy
from repro_torch.models import common as cm
from repro_torch.models import ssm
from repro_torch.models.common import Ctx
from test_torch_families import RECURRENT_FP

SCAN_TOL = 1e-6
TOL = 1e-5
SPEC = dict(d_model=24, d_inner=40, d_state=6, d_conv=4)


def lin(left, right):
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def maxplus(mx):
    def fn(left, right):
        al, bl = left
        ar, br = right
        return al + ar, mx(bl + ar, br)
    return fn


@pytest.mark.parametrize("S", [1, 2, 7, 24, 33, 128])
@pytest.mark.parametrize("combine", ["linear", "maxplus"])
def test_associative_scan_matches_jax(S, combine):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 1.0, (2, S, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, S, 5, 3)).astype(np.float32)
    jfn, tfn = (lin, lin) if combine == "linear" else (maxplus(jnp.maximum),
                                                        maxplus(torch.maximum))
    want = jax.lax.associative_scan(jfn, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = cm.associative_scan(tfn, (torch.from_numpy(a), torch.from_numpy(b)), 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_associative_scan_matches_a_sequential_loop_and_differentiates():
    """The scan's meaning: h_t = a_t h_{t-1} + b_t from h = 0, with a
    gradient through every round."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.3, 1.0, (3, 21, 4)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((3, 21, 4)).astype(np.float32))
    _, h = cm.associative_scan(lin, (a, b), 1)
    ref, hs = torch.zeros(3, 4), []
    for t in range(21):
        ref = a[:, t] * ref + b[:, t]
        hs.append(ref)
    want = torch.stack(hs, 1)
    np.testing.assert_allclose(h.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(h.sum(), a)
    (gw,) = torch.autograd.grad(want.sum(), a)
    np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=1e-4, atol=1e-5)


def test_softplus_and_log_sigmoid_follow_jax_past_the_torch_threshold():
    x = np.array([-80.0, -30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 25.0, 60.0], np.float32)
    np.testing.assert_allclose(cm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(cm.log_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(x)), rtol=1e-6, atol=0)


def np_ssm_params(seed=0):
    """Params of ``jssm.init``'s layout made with numpy."""
    shapes = jax.eval_shape(lambda k: jssm.init(k, jssm.SSMSpec(**SPEC)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key if path[-1].key != "w" else path[-2].key
        if name in RECURRENT_FP:
            return RECURRENT_FP[name](rng, s.shape)
        lim = 1.0 / np.sqrt(s.shape[-2])
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def ssm_pair():
    p = np_ssm_params()
    x = np.random.default_rng(1).standard_normal((2, 19, SPEC["d_model"])).astype(np.float32)
    return p, x


def ctxs(B, S):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return (JCtx(cfg=None, positions=jnp.asarray(pos)),
            Ctx(cfg=None, positions=torch.from_numpy(pos.copy())))


def shapes_of(tree) -> dict:
    return {"/".join(k.key for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_layout_matches_jax():
    spec = ssm.SSMSpec(**SPEC)
    got = ssm.init(torch.Generator().manual_seed(0), spec)
    want = jssm.init(jax.random.PRNGKey(0), jssm.SSMSpec(**SPEC))
    assert shapes_of(got) == shapes_of(want)
    for k in ("A_log", "D", "dt_bias"):  # JAX's deterministic FP leaves
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_conv_causal_matches_jax(ssm_pair):
    p, x = ssm_pair
    want = jssm._conv_causal(jnp.asarray(x[..., :SPEC["d_inner"] // 2]),
                             jnp.asarray(p["conv_w"][:, :SPEC["d_inner"] // 2]))
    got = ssm._conv_causal(torch.from_numpy(x[..., :SPEC["d_inner"] // 2]),
                           torch.from_numpy(p["conv_w"][:, :SPEC["d_inner"] // 2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_apply_matches_jax(ssm_pair):
    p, x = ssm_pair
    jc, tc = ctxs(*x.shape[:2])
    want = jssm.apply(jc, jax.tree.map(jnp.asarray, p), jssm.SSMSpec(**SPEC), jnp.asarray(x))
    got = ssm.apply(tc, params_from_numpy(p, device="cpu"), ssm.SSMSpec(**SPEC),
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def prefill_both(p, x):
    jc, tc = ctxs(*x.shape[:2])
    jspec, spec = jssm.SSMSpec(**SPEC), ssm.SSMSpec(**SPEC)
    jout, jst = j_ssm_prefill(jc, jax.tree.map(jnp.asarray, p), jspec, jnp.asarray(x),
                              jssm.init_cache(jspec, x.shape[0], jnp.float32))
    out, st = ssm.prefill(tc, params_from_numpy(p, device="cpu"), spec, torch.from_numpy(x))
    return (out, st), (jout, jst)


def test_prefill_final_state_matches_jax(ssm_pair):
    p, x = ssm_pair
    (out, st), (jout, jst) = prefill_both(p, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    assert set(st) == set(jst) == {"h", "conv"}
    for k in st:
        assert st[k].shape == jst[k].shape
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=TOL, atol=TOL)


def test_decode_from_the_prefill_state_matches_jax(ssm_pair):
    """Three steps from the prompt's state, each package on its own state."""
    p, x = ssm_pair
    (_, st), (_, jst) = prefill_both(p, x)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, SPEC["d_model"])).astype(np.float32)
        jc, tc = ctxs(2, 1)
        jy, jst = jssm.decode(jc, jp, jssm.SSMSpec(**SPEC), jnp.asarray(xt), jst)
        y, st = ssm.decode(tc, tp, ssm.SSMSpec(**SPEC), torch.from_numpy(xt), st)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=TOL, atol=TOL)


def test_decode_continues_apply():
    """apply over S tokens equals prefill of S - 2, then two decode steps."""
    p = params_from_numpy(np_ssm_params(3), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 12, SPEC["d_model"])).astype(np.float32))
    spec = ssm.SSMSpec(**SPEC)
    full = ssm.apply(ctxs(2, 12)[1], p, spec, x)
    _, st = ssm.prefill(ctxs(2, 10)[1], p, spec, x[:, :10])
    for t in (10, 11):
        y, st = ssm.decode(ctxs(2, 1)[1], p, spec, x[:, t:t + 1], st)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(), rtol=TOL, atol=TOL)


def test_prefill_shorter_than_the_conv_state_raises(ssm_pair):
    p, x = ssm_pair
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        ssm.prefill(ctxs(2, 2)[1], params_from_numpy(p, device="cpu"),
                    ssm.SSMSpec(**SPEC), torch.from_numpy(x[:, :2]))
