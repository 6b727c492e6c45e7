"""Port parity: the grouped (stacked-expert) tier of the packed
dequant-matmul vs the JAX package.

``qmm_grouped_ref`` (one expert at a time), ``qmm_grouped_dense_ref``
(one dequant of (E, K, N)) and ``qmm(backend="torch")`` on a stacked node
are held against the XLA-backend JAX ``qmm`` (which runs JAX's
``qmm_grouped_ref`` / ``qmm_grouped_dense_ref``) and the Pallas kernel in
interpret mode at 1e-4 (f32 sums in another order), over
container bits 8/4/2 and a W3 code in an int8 container, per-channel and
group-64 scales, 1..64 rows per expert, (B, E, C, K) leading dims and a
ragged N. The CUDA kernel is tested on the card in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import rtn_pack_leaf as j_rtn_pack_leaf
from repro.kernels.qmatmul import ops as jops
from repro_torch.deploy import pack_codes, rtn_pack_leaf
from repro_torch.kernels import spec
from repro_torch.kernels.qmatmul import ops, ref

TOL = 1e-4


def node(E, K, N, bits, group=None, seed=0):
    """A stacked RTN node made in both packages from the same numpy
    weights: (numpy packed codes, numpy scales), byte-identical (JAX
    jitted, as its artifacts are made: the port's scales are the jitted
    ones)."""
    w = np.random.default_rng(seed).normal(size=(E, K, N)).astype(np.float32)
    wp, s = rtn_pack_leaf(torch.from_numpy(w), bits, group)
    jwp, js = jax.jit(j_rtn_pack_leaf, static_argnums=(1, 2))(jnp.asarray(w), bits, group)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    return wp.numpy(), s.numpy()


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", [8, 4, 2, 3])  # 3: a W3 code in an int8 container
@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 64])
def test_grouped_refs_and_qmm_match_jax(bits, group, m):
    E, K, N = 3, 128, 96
    wp, s = node(E, K, N, bits, group, seed=bits)
    x = np.random.default_rng(m).standard_normal((E, m, K)).astype(np.float32)
    jqw = jops.from_node({"w": jnp.asarray(wp), "qscale": jnp.asarray(s)}, K)
    tqw = ops.from_node({"w": torch.from_numpy(wp), "qscale": torch.from_numpy(s)}, K)
    assert tqw.bits == jqw.bits == (8 if bits == 3 else bits)
    # the JAX dispatcher runs jref.qmm_grouped_ref up to 8 rows, else
    # jref.qmm_grouped_dense_ref
    want = jops.qmm(jnp.asarray(x), jqw, backend="xla")
    tx = torch.from_numpy(x)
    got = ops.qmm(tx, tqw, backend="torch")
    assert got.shape == (E, m, N)
    close(got, want)
    close(ref.qmm_grouped_ref(tx, tqw.packed, tqw.scales, tqw.bits), want)
    close(ref.qmm_grouped_dense_ref(tx, tqw.packed, tqw.scales, tqw.bits), want)


@pytest.mark.parametrize("c", [3, 16])  # decode (per-expert loop) / dense ref
@pytest.mark.parametrize("n", [128, 200])  # 200: ragged N
def test_grouped_lead_dims_match_jax(c, n):
    """(B, E, C, K) activations keep the expert axis on the codes' axis."""
    B, E, K = 2, 4, 64
    wp, s = node(E, K, n, 4, seed=7)
    x = np.random.default_rng(c).standard_normal((B, E, c, K)).astype(np.float32)
    jqw = jops.from_node({"w": jnp.asarray(wp), "qscale": jnp.asarray(s)}, K)
    tqw = ops.from_node({"w": torch.from_numpy(wp), "qscale": torch.from_numpy(s)}, K)
    got = ops.qmm(torch.from_numpy(x), tqw)  # auto: the plain version on the CPU
    assert got.shape == (B, E, c, n)
    close(got, jops.qmm(jnp.asarray(x), jqw, backend="xla"))
    close(got, jops.qmm(jnp.asarray(x), jqw, backend="pallas"))


def test_grouped_tier_counts_and_picks_the_ref(monkeypatch):
    wp, s = node(2, 64, 32, 4)
    qw = ops.from_node({"w": torch.from_numpy(wp), "qscale": torch.from_numpy(s)}, 64)
    used = []
    for name in ("qmm_grouped_ref", "qmm_grouped_dense_ref"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name: (used.append(_n), _f(*a))[1])
    ops.reset_tier_counts()
    ops.qmm(torch.zeros((2, ops.DECODE_M_MAX, 64)), qw)
    ops.qmm(torch.zeros((3, 2, 5, 64)), qw)  # B'*C = 15 rows per expert
    assert used == ["qmm_grouped_ref", "qmm_grouped_dense_ref"]
    assert ops.TIER_COUNTS == {"decode": 0, "prefill": 0, "grouped": 2}
    ops.reset_tier_counts()


def test_grouped_rejects_bad_activations():
    wp, s = node(5, 64, 32, 4)
    qw = ops.from_node({"w": torch.from_numpy(wp), "qscale": torch.from_numpy(s)}, 64)
    with pytest.raises(ops.PackedNodeError, match="rank-2"):
        ops.qmm(torch.ones((4, 64)), qw)
    with pytest.raises(ops.PackedNodeError, match="E=2"):
        ops.qmm(torch.ones((2, 4, 64)), qw)
    with pytest.raises(ops.PackedNodeError, match="K=32"):
        ops.qmm(torch.ones((5, 4, 32)), qw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.qmm(torch.ones((5, 4, 64)), qw, backend="cuda")


def test_grouped_shape_contract():
    sp = spec.describe_qmatmul_grouped((64, 8, 2048), (64, 1024, 1408),
                                       (64, 1, 1408), bits=4)
    assert (sp["E"], sp["M"], sp["K"], sp["N"], sp["G"]) == (64, 8, 2048, 1408, 1)
    sp = spec.describe_qmatmul_grouped((3, 9, 128), (3, 128, 96), (3, 2, 96), bits=8)
    assert (sp["M"], sp["group"]) == (9, 64)
    with pytest.raises(spec.KernelSpecError, match="expert axes disagree"):
        spec.describe_qmatmul_grouped((4, 8, 128), (3, 64, 32), (3, 1, 32), bits=4)
    with pytest.raises(spec.KernelSpecError, match="expert axes disagree"):
        spec.describe_qmatmul_grouped((3, 8, 128), (3, 64, 32), (4, 1, 32), bits=4)
    with pytest.raises(spec.KernelSpecError, match="packed rows"):
        spec.describe_qmatmul_grouped((3, 8, 128), (3, 32, 32), (3, 1, 32), bits=4)
    with pytest.raises(spec.KernelSpecError, match="do not span"):
        spec.describe_qmatmul_grouped((3, 8, 128), (3, 64, 32), (3, 1, 31), bits=4)
    with pytest.raises(spec.KernelSpecError, match="3-D"):
        spec.describe_qmatmul_grouped((8, 128), (3, 64, 32), (3, 1, 32), bits=4)


@pytest.mark.parametrize("m", [1, 8, 9])
def test_grouped_scales_shared_by_the_experts(m):
    """A calibrated export's expert scales are one (1, G, N) set shared by
    every expert: the grouped tier serves it as that set repeated per
    expert, in the decode (<= 8 rows) and prefill forms."""
    rng = np.random.default_rng(m)
    codes = torch.from_numpy(rng.integers(-2, 2, (4, 64, 48)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, (1, 1, 48)).astype(np.float32))
    packed = pack_codes(codes, 64, 2)
    x = torch.from_numpy(rng.normal(size=(4, m, 64)).astype(np.float32))
    got = ops.qmm(x, ops.QuantizedLinear(packed, s, 2, 64))
    want = ops.qmm(x, ops.QuantizedLinear(packed, s.expand(4, 1, 48).contiguous(), 2, 64))
    dense = torch.einsum("emk,ekn->emn", x, codes.float() * s)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=TOL, atol=TOL)
