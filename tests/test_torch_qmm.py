"""Port parity: packed dequant-matmul (repro_torch.kernels.qmatmul) vs the
JAX package.

The plain PyTorch versions are held against JAX ``qgemv_ref`` /
``qmatmul_ref`` and against the Pallas ``qgemv`` / ``qmatmul`` kernels in
interpret mode, at 1e-4 (f32 sums taken in another order). The CUDA
kernels themselves are tested on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul import kernel as jkernel
from repro.kernels.qmatmul import ops as jops
from repro.kernels.qmatmul import ref as jref
from repro_torch.core.quantizer import pack_int
from repro_torch.kernels import spec
from repro_torch.kernels.qmatmul import kernel, ops, ref
from torch_threads import one_torch_thread  # noqa: F401


TOL = 1e-4


def case(bits, k, n, g, m, seed=0):
    """Numpy inputs: x (m, k) f32, packed codes (k*bits/8, n), scales (g, n)."""
    rng = np.random.default_rng(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    wp = pack_int(torch.from_numpy(codes), bits).numpy()
    s = rng.uniform(0.005, 0.02, size=(g, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, wp, s


def t(a):
    return torch.from_numpy(a)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("m", [1, 8])
def test_qgemv_plain_matches_jax(bits, g, m):
    x, wp, s = case(bits, 256, 256, g, m)
    got = ref.qgemv_ref(t(x), t(wp), t(s), bits).numpy()
    close(got, jref.qgemv_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s), bits))
    close(got, jkernel.qgemv(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s),
                             bits=bits, bn=128, interpret=True))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g", [1, 2])
def test_qmatmul_plain_matches_jax(bits, g):
    x, wp, s = case(bits, 256, 256, g, 128)
    got = ref.qmatmul_ref(t(x), t(wp), t(s), bits).numpy()
    close(got, jref.qmatmul_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s), bits))
    close(got, jkernel.qmatmul(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s),
                               bits=bits, bm=128, bn=128, interpret=True))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [8, 520])
def test_qmm_ragged_matches_jax(bits, m):
    """Ragged N=200 (and M=520 on the prefill tier): the JAX dispatcher pads
    to its tiles and slices back; the port needs no padding."""
    x, wp, s = case(bits, 256, 200, 2, m, seed=3)
    jqw = jops.QuantizedLinear(jnp.asarray(wp), jnp.asarray(s), bits, 256)
    tqw = ops.QuantizedLinear(t(wp), t(s), bits, 256)
    got = ops.qmm(t(x), tqw).numpy()
    assert got.shape == (m, 200)
    close(got, jops.qmm(jnp.asarray(x), jqw, backend="pallas"))
    close(got, jops.qmm(jnp.asarray(x), jqw, backend="xla"))


def test_qmm_flattens_leading_dims():
    x, wp, s = case(4, 128, 64, 1, 2 * 3)
    qw = ops.QuantizedLinear(t(wp), t(s), 4, 128)
    got = ops.qmm(t(x).reshape(2, 3, 128), qw)
    assert got.shape == (2, 3, 64)
    close(got.reshape(6, 64).numpy(), ref.qmatmul_ref(t(x), t(wp), t(s), 4).numpy())


def test_select_tier_and_counts():
    x, wp, s = case(4, 128, 64, 1, 8)
    qw = ops.QuantizedLinear(t(wp), t(s), 4, 128)
    ops.reset_tier_counts()
    assert ops.select_tier(1, qw) == "decode"
    assert ops.select_tier(ops.DECODE_M_MAX, qw) == "decode"
    assert ops.select_tier(ops.DECODE_M_MAX + 1, qw) == "prefill"
    ops.qmm(t(x), qw)
    ops.qmm(t(np.tile(x, (2, 1))), qw)
    assert ops.TIER_COUNTS == {"decode": 1, "prefill": 1, "grouped": 0}
    stacked = ops.QuantizedLinear(t(wp)[None], t(s)[None], 4, 128)
    assert ops.select_tier(1, stacked) == "grouped"
    got = ops.qmm(t(x)[None], stacked)  # the grouped tier runs and counts
    assert ops.TIER_COUNTS == {"decode": 1, "prefill": 1, "grouped": 1}
    close(got[0].numpy(), ref.qgemv_ref(t(x), t(wp), t(s), 4).numpy())
    ops.reset_tier_counts()
    assert set(ops.TIER_COUNTS.values()) == {0}


def test_decode_tier_override(monkeypatch):
    x, wp, s = case(2, 128, 64, 1, 4)
    qw = ops.QuantizedLinear(t(wp), t(s), 2, 128)
    monkeypatch.setenv("REPRO_QMM_DECODE_TIER", "off")
    assert ops.select_tier(4, qw) == "prefill"
    ops.set_decode_tier(True)  # code override beats the env
    try:
        assert ops.select_tier(4, qw) == "decode"
        ops.set_decode_tier(False)
        monkeypatch.delenv("REPRO_QMM_DECODE_TIER")
        assert ops.select_tier(4, qw) == "prefill"
    finally:
        ops.set_decode_tier(None)
    assert ops.select_tier(4, qw) == "decode"


def test_measured_dispatch_table(monkeypatch):
    x, wp, s = case(4, 128, 64, 1, 4)
    qw = ops.QuantizedLinear(t(wp), t(s), 4, 128)
    assert ops.dispatch_mode() == "heuristic"
    ops.set_dispatch_table({(128, 64, 4): "prefill"})
    try:
        assert ops.dispatch_mode() == "measured"
        assert ops.select_tier(4, qw) == "prefill"
        monkeypatch.setenv("REPRO_QMM_DISPATCH", "heuristic")
        assert ops.select_tier(4, qw) == "decode"
    finally:
        ops.set_dispatch_table(None)


def test_packed_node_errors():
    wp = torch.zeros((64, 32), dtype=torch.int8)
    s = torch.ones((1, 32))
    assert ops.from_node({"w": wp, "qscale": s}, 128).bits == 4
    assert ops.from_node({"w": wp, "qscale": s}, 256).bits == 2
    with pytest.raises(ops.PackedNodeError, match="at 'a/wq'"):
        ops.from_node({"w": wp[None, None], "qscale": s}, 128, path="a/wq")
    with pytest.raises(ops.PackedNodeError, match="rank"):
        ops.from_node({"w": wp, "qscale": s[None]}, 128)
    with pytest.raises(ops.PackedNodeError, match="do not divide"):
        ops.from_node({"w": wp, "qscale": s}, 100)
    with pytest.raises(ops.PackedNodeError, match="values/byte"):
        ops.from_node({"w": wp, "qscale": s}, 64 * 8)


def test_pack_weights_roundtrip():
    rng = np.random.default_rng(5)
    codes = rng.integers(-8, 8, size=(64, 16)).astype(np.int8)
    qw = ops.pack_weights(t(codes), np.full(16, 0.5, np.float32), 4)
    assert qw.scales.shape == (1, 16) and qw.k == 64
    close(ref.dequant(qw.packed, qw.scales, 4, 64).numpy(), codes * 0.5)


def test_cuda_backend_refuses_cpu_tensors():
    x, wp, s = case(4, 128, 64, 1, 4)
    qw = ops.QuantizedLinear(t(wp), t(s), 4, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.qmm(t(x), qw, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.qmm(t(x), qw, backend="xla")


def test_kernel_shape_contract():
    with pytest.raises(spec.KernelSpecError, match="M=9"):
        spec.describe_qgemv((9, 128), (64, 32), (1, 32), bits=4)
    with pytest.raises(spec.KernelSpecError, match="packed rows"):
        spec.describe_qmatmul((16, 128), (32, 32), (1, 32), bits=4)
    with pytest.raises(spec.KernelSpecError, match="do not span"):
        spec.describe_qmatmul((16, 128), (64, 32), (1, 31), bits=4)
    with pytest.raises(spec.KernelSpecError, match="packing factor"):
        spec.describe_qmatmul((16, 128), (32, 32), (64, 32), bits=2)
    with pytest.raises(spec.KernelSpecError, match="bits"):
        spec.describe_qgemv((1, 128), (64, 32), (1, 32), bits=3)
    sp = spec.describe_qmatmul((520, 256), (128, 200), (2, 200), bits=4)
    assert (sp["M"], sp["K"], sp["N"], sp["G"], sp["group"]) == (520, 256, 200, 2, 128)
    assert spec.largest_tile(3840, 512, 8) == 480


def test_kernel_module_builds_nothing_on_import():
    if not torch.cuda.is_available():  # nothing launched, so nothing built
        assert kernel._LIB is None and not kernel.BUILD_INFO
    assert kernel.build_dir().name == "kernels"
    assert all(src.exists() for src in kernel.SOURCES)
