"""Port parity: int8-KV decode attention (repro_torch.kernels.kvattn) vs the
JAX package's ``repro.kernels.kvattn`` on the same numpy inputs.

* ``quantize_kv``: the JAX engine quantizes inside jitted programs, where
  XLA rewrites ``amax / 127`` as ``amax * f32(1/127)``; the port's codes
  and f32 scales equal the *jitted* JAX ones bit for bit, before and after
  the float16 cast the paged pool stores.
* attention: the port's plain version (``kv_decode_ref``,
  ``attend_int8(backend="torch")``) vs the JAX Pallas kernel in interpret
  mode and its reference, within 1e-4 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kvattn.kernel import kv_decode as j_kv_decode
from repro.kernels.kvattn.ops import quantize_kv as j_quantize_kv
from repro.kernels.kvattn.ref import kv_decode_ref as j_kv_decode_ref
from repro_torch.kernels import spec
from repro_torch.kernels.kvattn import ops
from repro_torch.kernels.kvattn.ref import kv_decode_ref

TOL = 1e-4


def _kv(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((4, 64, 2, 64), 1.0),
                                         ((3, 17, 4, 32), 3.0),
                                         ((2, 9, 1, 128), 1e-3)])
def test_quantize_kv_matches_jitted_jax(shape, scale):
    rng = np.random.default_rng(0)
    k, v = _kv(rng, shape, scale), _kv(rng, shape, scale)
    k[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    want = [np.asarray(a) for a in jax.jit(j_quantize_kv)(jnp.asarray(k), jnp.asarray(v))]
    got = [t.numpy() for t in ops.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))]
    for g, w in zip(got[:2], want[:2]):  # int8 codes
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2:], want[2:]):  # f32 scales, bit for bit
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
        np.testing.assert_array_equal(
            g.astype(np.float16).view(np.uint16),
            np.asarray(jnp.asarray(w).astype(jnp.float16)).view(np.uint16))


def _case(rng, B, H, K, hd, S, *, holes=False, empty_row=False):
    q = _kv(rng, (B, H, hd))
    k8, v8, ks, vs = (np.array(a) for a in jax.jit(j_quantize_kv)(
        jnp.asarray(_kv(rng, (B, S, K, hd))), jnp.asarray(_kv(rng, (B, S, K, hd)))))
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if holes:
        kpos[rng.random((B, S)) < 0.3] = -1
    if empty_row:
        kpos[0] = -1
    cur = rng.integers(S // 4, S, size=(B,)).astype(np.int32)
    return q, k8, v8, ks, vs, kpos, cur


# test_kernels.py's shapes and windows, plus kpos holes, a row with no
# valid slot and ragged S (not a multiple of any tile)
CASES = [dict(B=2, H=8, K=2, hd=64, S=256, bs=128),
         dict(B=1, H=4, K=4, hd=32, S=128, bs=128),
         dict(B=3, H=4, K=1, hd=128, S=512, bs=256),  # MQA
         dict(B=2, H=8, K=2, hd=64, S=256, bs=128, holes=True),
         dict(B=3, H=4, K=4, hd=32, S=128, bs=64, empty_row=True),
         dict(B=2, H=6, K=3, hd=32, S=100, bs=100)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("window", [None, 64])
def test_kv_decode_plain_matches_jax(case, window):
    rng = np.random.default_rng(1)
    kw = {k: v for k, v in case.items() if k != "bs"}
    arrays = _case(rng, **kw)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    j_kernel = np.asarray(j_kv_decode(*jargs, window=window, bs=case["bs"],
                                      interpret=True))
    j_ref = np.asarray(j_kv_decode_ref(*jargs, window))
    got = kv_decode_ref(*targs, window=window).numpy()
    via_ops = ops.attend_int8(*targs, window=window, backend="torch").numpy()
    np.testing.assert_array_equal(via_ops, got)
    np.testing.assert_allclose(got, j_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, j_kernel, atol=TOL, rtol=TOL)
    if case.get("empty_row"):  # no valid slot: the mean of V over S
        v = arrays[2][0].astype(np.float32) * arrays[4][0][..., None]
        mean = np.repeat(v.mean(0), case["H"] // case["K"], axis=0)
        np.testing.assert_allclose(got[0], mean, atol=TOL, rtol=TOL)


def test_attend_int8_backends():
    rng = np.random.default_rng(2)
    targs = [torch.from_numpy(a) for a in _case(rng, 2, 4, 2, 32, 64)]
    auto = ops.attend_int8(*targs)  # CPU tensors: the plain version
    np.testing.assert_array_equal(auto.numpy(), kv_decode_ref(*targs).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attend_int8(*targs, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.attend_int8(*targs, backend="pallas")


def test_describe_kv_decode_contract():
    with pytest.raises(spec.KernelSpecError, match="not divisible into kv heads"):
        spec.describe_kv_decode((2, 6, 64), (2, 96, 4, 64))
    with pytest.raises(spec.KernelSpecError, match="head dim"):
        spec.describe_kv_decode((2, 4, 66), (2, 96, 4, 66))
    with pytest.raises(spec.KernelSpecError, match="multiple of 8"):
        spec.describe_kv_decode((2, 4, 20), (2, 96, 4, 20))
    assert spec.describe_kv_decode((2, 4, 120), (2, 96, 4, 120))["body"] == "v8"
    with pytest.raises(spec.KernelSpecError, match="at most 16"):
        spec.describe_kv_decode((2, 32, 64), (2, 96, 1, 64))
    with pytest.raises(spec.KernelSpecError, match="kpos"):
        spec.describe_kv_decode((2, 4, 64), (2, 96, 4, 64), kpos_shape=(2, 95))
    sp = spec.describe_kv_decode((8, 12, 64), (8, 100, 12, 64))  # ragged S is fine
    assert (sp["G"], sp["S"], sp["hd"]) == (1, 100, 64)


def test_kvattn_module_builds_nothing_on_import():
    from repro_torch.kernels.kvattn import kernel

    if not torch.cuda.is_available():
        assert kernel._LIB is None and not kernel.BUILD_INFO
    assert all(src.exists() for src in kernel.SOURCES)
