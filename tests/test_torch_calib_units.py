"""The calibration slice's building blocks against the JAX package, on the
CPU: the same numpy inputs go through the JAX function and the port's.

Tolerances: integers, codes, scales and the hardened forward exactly;
``init_v`` with identical signs and values within 1e-4 (XLA's CPU ``log``
is not correctly rounded: it differs from torch's by an ulp in ~13% of
elements, and one run of this file saw 4e-5; the sign of ``v``, which is
all that hardening reads, and so the RTN start point, is exact); soft
rounding and its regularizer within 1e-5; LSQ, the STE and
Adam within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaround as jada
from repro.core import lsq as jlsq
from repro.core import quantizer as jq
from repro.kernels.fakequant import ops as jfq_ops
from repro.kernels.fakequant.ref import fakequant_ref as jfakequant_ref
from repro.optim import adam as jadam
from repro_torch.core import adaround as tada
from repro_torch.core import lsq as tlsq
from repro_torch.core import quantizer as tq
from repro_torch.kernels.fakequant import ops as tfq_ops
from repro_torch.kernels.fakequant.ref import fakequant_ref
from repro_torch.kernels.spec import KernelSpecError, describe_fakequant
from repro_torch.optim import adam as tadam
from torch_threads import one_torch_thread  # noqa: F401


def T(a):
    return torch.tensor(np.asarray(a))


def weights(shape, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def both_cfgs(**kw):
    return jq.QConfig(**kw), tq.QConfig(**kw)


def t_state(js):
    return tq.QState(torch.tensor(np.asarray(js.scale)),
                     torch.tensor(np.asarray(js.zero_point)))


def j_state(ts):
    return jq.QState(jnp.asarray(ts.scale.numpy()), jnp.asarray(ts.zero_point.numpy()))


# (kw, shape): per-channel / per-tensor / grouped, minmax and MSE, W2/W4/W8,
# symmetric and asymmetric
QCASES = [
    (dict(bits=2, channel_axis=-1, scale_method="mse"), (128, 96)),
    (dict(bits=4, channel_axis=-1, scale_method="mse"), (64, 48)),
    (dict(bits=4, channel_axis=-1, scale_method="minmax"), (64, 48)),
    (dict(bits=8, channel_axis=-1, scale_method="mse"), (96, 32)),
    (dict(bits=3, channel_axis=None, scale_method="mse"), (32, 40)),
    (dict(bits=4, channel_axis=-1, group_size=32, scale_method="mse"), (128, 48)),
    (dict(bits=2, channel_axis=-1, group_size=16, scale_method="minmax"), (64, 24)),
    (dict(bits=4, symmetric=False, channel_axis=-1, scale_method="mse"), (64, 48)),
    (dict(bits=4, symmetric=False, channel_axis=-1, group_size=32,
          scale_method="minmax"), (64, 48)),
]


def test_make_batches_tokens_match_jax():
    from repro.data import Corpus as JCorpus
    from repro.data import CorpusConfig as JCorpusConfig
    from repro.data import make_batches as jmake
    from repro_torch.data import Corpus, CorpusConfig, make_batches

    jb = jmake(JCorpus(JCorpusConfig(vocab=512)), 3, 4, 40, seed=1, start_step=5)
    tb = make_batches(Corpus(CorpusConfig(vocab=512)), 3, 4, 40, seed=1, start_step=5)
    for a, b in zip(jb, tb):
        assert b["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(a["tokens"]), b["tokens"].numpy())


def test_mse_ratios_are_jax_linspace():
    want = np.asarray(jnp.linspace(0.35, 1.0, 80))
    got = np.asarray(tq.MSE_RATIOS, np.float64).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert [float(x) for x in got] == list(tq.MSE_RATIOS)


def test_round_is_half_to_even_in_both():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(T(x)).numpy(), np.asarray(jnp.round(x)))
    np.testing.assert_array_equal(torch.round(T(x)).numpy(), [-2, -2, -0, 0, 2, 2, 4])


@pytest.mark.parametrize("kw,shape", QCASES)
def test_init_qstate_and_codes_match_jax(kw, shape):
    jc, tc = both_cfgs(**kw)
    w = weights(shape, seed=shape[0] + kw["bits"])
    js = jq.init_qstate(jnp.asarray(w), jc)
    ts = tq.init_qstate(T(w), tc)
    np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))
    np.testing.assert_array_equal(ts.zero_point.numpy(), np.asarray(js.zero_point))
    jcodes = jq.quantize_int(jnp.asarray(w), js, jc)
    tcodes = tq.quantize_int(T(w), ts, tc)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tq.dequantize_int(tcodes, ts, tc).numpy(),
                                  np.asarray(jq.dequantize_int(jcodes, js, jc)))
    np.testing.assert_array_equal(tq.quantize_dequant(T(w), ts, tc).numpy(),
                                  np.asarray(jq.quantize_dequant(jnp.asarray(w), js, jc)))


@pytest.mark.parametrize("kw,shape", QCASES)
def test_adaround_matches_jax(kw, shape):
    jc, tc = both_cfgs(**kw)
    w = weights(shape, seed=7)
    js = jq.init_qstate(jnp.asarray(w), jc)
    ts = t_state(js)
    jv = np.asarray(jada.init_v(jnp.asarray(w), js, jc))
    tv = tada.init_v(T(w), ts, tc)
    np.testing.assert_array_equal(np.sign(tv.numpy()), np.sign(jv))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tada.hard_quant(T(w), tv, ts, tc).numpy(),
                                  tq.quantize_dequant(T(w), ts, tc).numpy())
    # perturbed logits so rounding is not RTN everywhere
    v = (jv + np.random.default_rng(1).normal(0, 2, jv.shape)).astype(np.float32)
    jw, jvv = jnp.asarray(w), jnp.asarray(v)
    np.testing.assert_array_equal(tada.hard_quant(T(w), T(v), ts, tc).numpy(),
                                  np.asarray(jada.hard_quant(jw, jvv, js, jc)))
    np.testing.assert_array_equal(tada.hard_int_codes(T(w), T(v), ts, tc).numpy(),
                                  np.asarray(jada.hard_int_codes(jw, jvv, js, jc)))
    np.testing.assert_allclose(tada.soft_quant(T(w), T(v), ts, tc).numpy(),
                               np.asarray(jada.soft_quant(jw, jvv, js, jc)),
                               rtol=0, atol=1e-5)
    for beta in (20.0, 7.3, 2.0):
        np.testing.assert_allclose(float(tada.round_reg(T(v), beta)),
                                   float(jada.round_reg(jvv, jnp.float32(beta))),
                                   rtol=1e-5)


def test_soft_quant_grad_matches_jax():
    jc, tc = both_cfgs(bits=2, channel_axis=-1, scale_method="mse")
    w = weights((64, 32), seed=3)
    js = jq.init_qstate(jnp.asarray(w), jc)
    ts = t_state(js)
    v = np.asarray(jada.init_v(jnp.asarray(w), js, jc))
    g = weights((64, 32), seed=4, scale=1.0)

    def jloss(vv):
        return jnp.sum(jada.soft_quant(jnp.asarray(w), vv, js, jc) * g) \
            + 0.01 * jada.round_reg(vv, jnp.float32(5.0))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    tv = T(v.copy()).requires_grad_()
    (tada.soft_quant(T(w), tv, ts, tc) * T(g)).sum().add(
        0.01 * tada.round_reg(tv, 5.0)).backward()
    np.testing.assert_allclose(tv.grad.numpy(), jg, rtol=1e-4, atol=1e-6)


def test_beta_schedule_matches_jax():
    for total in (10, 120, 200):
        for it in range(0, total, max(1, total // 17)):
            jb, je = jada.BetaSchedule()(jnp.float32(it), total)
            tb, te = tada.BetaSchedule()(it, total)
            assert (tb, te) == (float(jb), float(je)), (it, total)


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("K,N,per_row", [(128, 256, False), (64, 128, True),
                                         (96, 200, False)])
@pytest.mark.parametrize("bits", [2, 4])
def test_fakequant_ref_matches_jax_kernel(hard, K, N, per_row, bits):
    """The plain version against the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(K + N)
    w = rng.standard_normal((K, N)).astype(np.float32)
    v = rng.standard_normal((K, N)).astype(np.float32)
    s = rng.uniform(0.05, 0.5, (K if per_row else 1, N)).astype(np.float32)
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    from repro.kernels.fakequant.kernel import fakequant as jfakequant
    from repro.kernels.spec import largest_tile

    want = np.asarray(jfakequant(jnp.asarray(w), jnp.asarray(v), jnp.asarray(s),
                                 qmin=qmin, qmax=qmax, hard=hard,
                                 bk=largest_tile(K, 64), bn=largest_tile(N, 128),
                                 interpret=True))
    got = fakequant_ref(T(w), T(v), T(s), qmin, qmax, hard).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfakequant_ref(w, v, s, qmin, qmax, hard))) if hard else None
    if hard:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_adaround_forward_wrapper_and_typed_errors():
    jc, tc = both_cfgs(bits=4, channel_axis=-1, scale_method="mse")
    w = weights((64, 48), seed=5)
    ts = tq.init_qstate(T(w), tc)
    v = tada.init_v(T(w), ts, tc)
    for hard in (True, False):
        got = tfq_ops.adaround_forward(T(w), v, ts, tc, hard=hard)
        want = np.asarray(jfq_ops.adaround_forward(
            jnp.asarray(w), jnp.asarray(v.numpy()), j_state(ts), jc, hard=hard,
            backend="xla"))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0 if hard else 1e-5)
    np.testing.assert_array_equal(
        tfq_ops.adaround_forward(T(w), v, ts, tc, hard=True).numpy(),
        tada.hard_quant(T(w), v, ts, tc).numpy())
    assert tfq_ops.covers(T(w), tc, ts.scale)
    # a stack of experts (E, K, N) with a scale shared across experts runs
    # as its (E*K, N) view; per-expert scales and 1-D weights do not
    stack, vs = torch.stack([T(w), 2 * T(w)]), torch.stack([v, -v])
    assert tfq_ops.covers(stack, tc, ts.scale[None])
    np.testing.assert_array_equal(
        tfq_ops.adaround_forward(stack, vs, tq.QState(ts.scale[None], ts.zero_point),
                                 tc, hard=True).numpy(),
        torch.stack([tada.hard_quant(T(w), v, ts, tc),
                     tada.hard_quant(2 * T(w), -v, ts, tc)]).numpy())
    per_expert = tq.QState(torch.stack([ts.scale, ts.scale]), ts.zero_point)
    assert not tfq_ops.covers(stack, tc, per_expert.scale)
    with pytest.raises(KernelSpecError, match="shared across its leading dims"):
        tfq_ops.adaround_forward(stack, vs, per_expert, tc, hard=True)
    with pytest.raises(KernelSpecError, match=r"\(K, N\)"):
        tfq_ops.adaround_forward(T(w)[0], v[0], ts, tc, hard=True)
    for bad in (dataclasses.replace(tc, group_size=16),
                dataclasses.replace(tc, symmetric=False)):
        assert not tfq_ops.covers(T(w), bad, ts.scale)
        with pytest.raises(KernelSpecError, match="symmetric per-channel"):
            tfq_ops.adaround_forward(T(w), v, ts, bad, hard=True)
    with pytest.raises(ValueError, match="backend"):
        tfq_ops.adaround_forward(T(w), v, ts, tc, hard=True, backend="xla")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfq_ops.adaround_forward(T(w), v, ts, tc, hard=True, backend="cuda")
    assert describe_fakequant((64, 48), (64, 48))["per_row"]
    for ws, ss in (((64, 48), (2, 48)), ((64, 48), (1, 40)), ((64,), (1, 64))):
        with pytest.raises(KernelSpecError, match="fakequant"):
            describe_fakequant(ws, ss)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_lsq_matches_jax(symmetric, bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((4, 16, 32)) * 2).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    js = jlsq.init_act_scale(jnp.asarray(x), bits, symmetric) * 0.7  # some clipping
    ts = tlsq.init_act_scale(T(x), bits, symmetric) * 0.7
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def jloss(xx, ss):
        return jnp.sum(jlsq.lsq_quant(xx, ss, bits, symmetric) * g)

    jy = np.asarray(jlsq.lsq_quant(jnp.asarray(x), js, bits, symmetric))
    jgx, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), js)
    tx, tsv = T(x.copy()).requires_grad_(), ts.clone().requires_grad_()
    ty = tlsq.lsq_quant(tx, tsv, bits, symmetric)
    (ty * T(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tsv.grad), float(jgs), rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(bits=4, channel_axis=-1),
                                dict(bits=3, channel_axis=-1, group_size=16)])
def test_fake_quant_ste_grads_match_jax(kw):
    jc, tc = both_cfgs(**kw)
    w = weights((64, 24), seed=11)
    js = jq.init_qstate(jnp.asarray(w), jc)
    js = jq.QState(js.scale * 0.6, js.zero_point)  # clip some weights
    ts = t_state(js)
    g = weights((64, 24), seed=12, scale=1.0)
    jgx = jax.grad(lambda xx: jnp.sum(jq.fake_quant_ste(xx, js, jc) * g))(jnp.asarray(w))
    tx = T(w.copy()).requires_grad_()
    y = tq.fake_quant_ste(tx, ts, tc)
    (y * T(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jq.quantize_dequant(jnp.asarray(w), js, jc)))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=0)
    assert 0 < float((tx.grad == 0).float().mean()) < 1


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adam_update_with_lr_tree_matches_jax(grad_clip):
    rng = np.random.default_rng(3)
    p = {"v": {"a": rng.standard_normal((8, 6)).astype(np.float32),
               "b": rng.standard_normal((5,)).astype(np.float32)},
         "s": {"a": np.float32(0.3)}}
    g = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), p)
    lr = {"v": {"a": 1.0, "b": 0.5}, "s": {"a": 0.04}}
    jcfg = jadam.AdamConfig(lr=1e-2, grad_clip=grad_clip, weight_decay=0.01)
    tcfg = tadam.AdamConfig(lr=1e-2, grad_clip=grad_clip, weight_decay=0.01)
    jp, js = jax.tree.map(jnp.asarray, p), jadam.init(jax.tree.map(jnp.asarray, p))
    tp = jax.tree.map(lambda x: torch.tensor(np.asarray(x)), p)
    tst = tadam.init(tp)
    for _ in range(3):
        jp, js = jadam.update(jcfg, jax.tree.map(jnp.asarray, g), js, jp, lr)
        tp, tst = tadam.update(tcfg, jax.tree.map(lambda x: torch.tensor(np.asarray(x)), g),
                               tst, tp, lr)
    assert int(tst["count"]) == 3 and tst["count"].dtype == torch.int32
    for path in (("v", "a"), ("v", "b"), ("s", "a")):
        a, b = jp, tp
        ma, mb = js["m"], tst["m"]
        for k in path:
            a, b, ma, mb = a[k], b[k], ma[k], mb[k]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(mb.numpy(), np.asarray(ma), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(tadam.global_norm(tp)), float(jadam.global_norm(jp)),
                               rtol=1e-5)


def test_cosine_schedule_matches_jax():
    jf, tf = jadam.cosine_schedule(1e-3, 10, 100), tadam.cosine_schedule(1e-3, 10, 100)
    for c in (0, 3, 10, 40, 99, 150):
        np.testing.assert_allclose(float(tf(torch.tensor(c, dtype=torch.int32))),
                                   float(jf(jnp.int32(c))), rtol=1e-6)
