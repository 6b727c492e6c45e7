"""The split of S in ``kv_decode`` (``csrc/kvattn.cu``), modelled on the CPU,
and its launch plan (``spec.plan_kv_decode``).

The CUDA kernel cannot run here. ``kvattn.ref.kv_decode_split_ref`` models
what it computes with the same inputs: the cache's tiles of 32 slots go to
the blocks of a cluster in contiguous shares and each block's share to its
warps; each warp runs the f32 online softmax tile by tile; warps merge in
warp order, blocks in rank order. The model is held against the plain
version (``kv_decode_ref``) within 1e-5 * max|ref| + 1e-6 for splits 1, 2,
4 and 8 and blocks of 4 and 8 warps, and against the JAX package's Pallas
``kv_decode`` in interpret mode within 1e-4 (f32 sums in another order),
over GQA, MQA, ragged S, a window, kpos holes, a row with no valid slot, head
dim 120 and a share whose every slot is masked. Inputs are made with numpy
from a seed and handed to both packages.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kvattn.kernel import kv_decode as j_kv_decode
from repro.kernels.kvattn.ops import quantize_kv as j_quantize_kv
from repro_torch.kernels import spec
from repro_torch.kernels.kvattn.ref import kv_decode_ref, kv_decode_split_ref

JAX_TOL = 1e-4


def _case(B, H, K, hd, S, *, holes=False, empty_row=False, masked_head=0, seed=0):
    """Numpy inputs: q, int8 K/V and f32 scales from the JAX quantizer,
    kpos = arange(S) (with -1 holes, a row with no valid slot, or the first
    ``masked_head`` slots of every row empty), cur in [S/2, S)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k8, v8, ks, vs = (np.array(a) for a in j_quantize_kv(
        jnp.asarray(rng.standard_normal((B, S, K, hd)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((B, S, K, hd)).astype(np.float32))))
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if holes:
        kpos[rng.random((B, S)) < 0.3] = -1
    if empty_row:
        kpos[0] = -1
    kpos[:, :masked_head] = -1
    cur = rng.integers(S // 2, S, size=(B,)).astype(np.int32)
    return q, k8, v8, ks, vs, kpos, cur


def _plans(S, hd, G):
    """Every split the kernel may take at this S (no empty share), with 4
    and 8 warps a block."""
    tiles = -(-S // spec.KV_TILE)
    return [spec.kv_plan(hd, G, warps, split) for warps in spec.KV_WARPS
            for split in spec.KV_SPLITS if split <= tiles]


# (B, H, K, hd, S, window, holes, empty_row, masked_head, JAX tile): GQA at
# TinyLlama's width, MQA at hd 128, ragged S, a window, holes, a row with no
# valid slot, h2o-danube3-4b's hd 120 (G 4), and the first 160 slots masked,
# so that under splits 4 and 8 the first shares hold only masked slots
CASES = [
    (2, 32, 4, 64, 256, None, False, False, 0, 128),
    (2, 16, 1, 128, 192, None, False, False, 0, 64),
    (3, 12, 12, 64, 100, None, False, False, 0, 100),
    (2, 8, 2, 64, 256, 64, False, False, 0, 128),
    (2, 8, 2, 64, 300, None, True, False, 0, 300),
    (3, 4, 4, 32, 130, None, False, True, 0, 130),
    (2, 32, 8, 120, 96, 40, True, False, 0, 96),
    (2, 4, 2, 64, 300, None, False, False, 160, 300),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-H{}-K{}-hd{}-S{}-w{}-holes{}-empty{}-mask{}".format(*c[:9]))
def test_split_model_matches_plain_and_jax(case):
    B, H, K, hd, S, window, holes, empty, masked, bs = case
    arrays = _case(B, H, K, hd, S, holes=holes, empty_row=empty, masked_head=masked)
    targs = [torch.from_numpy(a) for a in arrays]
    want = kv_decode_ref(*targs, window=window)
    j_out = np.asarray(j_kv_decode(*(jnp.asarray(a) for a in arrays), window=window, bs=bs,
                                   interpret=True))
    np.testing.assert_allclose(want.numpy(), j_out, atol=JAX_TOL, rtol=JAX_TOL)
    tol = 1e-5 * float(want.abs().max()) + 1e-6
    plans = _plans(S, hd, H // K)
    assert {p.split for p in plans} >= {1, 2} and len(plans) >= 4
    for plan in plans:
        got = kv_decode_split_ref(*targs, window=window, plan=plan)
        assert got.shape == (B, H, hd) and torch.isfinite(got).all()
        err = float((got - want).abs().max())
        assert err <= tol, (plan, err, tol)
        np.testing.assert_allclose(got.numpy(), j_out, atol=JAX_TOL, rtol=JAX_TOL)
    if empty:  # no valid slot: the mean of V over S, whatever the split
        v = arrays[2][0].astype(np.float32) * arrays[4][0][..., None]
        mean = np.repeat(v.mean(0), H // K, axis=0)
        np.testing.assert_allclose(got[0].numpy(), mean, atol=JAX_TOL, rtol=JAX_TOL)


def test_split_model_share_without_valid_slot():
    """A share whose slots are all masked has m = -1e30, not -inf, so its
    weight in the merge is exp(-1e30 - m*) = 0 and nothing turns NaN; a row
    whose every share is masked returns the mean of V, as the plain softmax
    does."""
    B, H, K, hd, S = 2, 4, 2, 64, 256
    arrays = _case(B, H, K, hd, S, masked_head=128)
    targs = [torch.from_numpy(a) for a in arrays]
    plan = spec.kv_plan(hd, H // K, 4, 8)  # 8 shares of one tile; the first 4 all masked
    np.testing.assert_allclose(kv_decode_split_ref(*targs, plan=plan).numpy(),
                               kv_decode_ref(*targs).numpy(), atol=1e-5, rtol=1e-5)
    targs[5][:] = -1
    got = kv_decode_split_ref(*targs, plan=plan)
    v = arrays[2].astype(np.float32) * arrays[4][..., None]
    mean = np.repeat(v.mean(1), H // K, axis=1)
    np.testing.assert_allclose(got.numpy(), mean, atol=1e-5, rtol=1e-5)


# --- the plan ---------------------------------------------------------------------

SHAPES = [(B, K, S, hd, G) for B in (1, 3, 8) for K in (1, 4, 12) for S in (1, 31, 96, 700, 4096)
          for hd in (16, 64, 120, 128, 256) for G in (1, 4, 16)]


def test_plan_depends_on_shapes_only():
    """plan_kv_decode takes integers (no tensor, no page size), and the same
    shape always gets the same plan."""
    params = inspect.signature(spec.plan_kv_decode).parameters
    assert list(params) == ["B", "K", "S", "hd", "G"]
    for shape in SHAPES[::7]:
        a = spec.plan_kv_decode(*shape)
        spec.plan_kv_decode.cache_clear()
        assert spec.plan_kv_decode(*shape) == a


@pytest.mark.parametrize("hd", [16, 64, 120, 128, 256])
def test_plan_never_makes_an_empty_share(hd):
    for (B, K, S, _, G) in SHAPES:
        p = spec.plan_kv_decode(B, K, S, hd, G)
        tiles = -(-S // spec.KV_TILE)
        assert p.split in spec.KV_SPLITS and p.split <= 8 and p.warps in spec.KV_WARPS
        shares = [(r + 1) * tiles // p.split - r * tiles // p.split for r in range(p.split)]
        assert min(shares) >= 1, (B, K, S, hd, G, p)
        if p.split > 1:  # a cluster split leaves every warp its minimum of tiles
            assert min(shares) >= p.warps * spec.KV_MIN_TILES
        assert p.rows * hd <= spec.KV_BLOCK_VALUES and p.rows * p.chunks >= G
        assert 128 * p.units >= p.rows * hd
        assert p.blocks == B * K * p.chunks * p.split
        assert spec.kv_smem(p.rows, hd, p.warps, 1) <= spec.SMEM_PER_BLOCK


def test_plan_bodies_and_main_path_shapes():
    """hd 64 takes the 16-byte body and hd 120 the 8-byte one; the engine's
    decode shape (8 slots, 12 heads of 64, 6 pages of 16) is not split, and
    its long-context shape (128 pages of 16) is."""
    assert spec.plan_kv_decode(8, 12, 96, 64).body == "v16"
    assert spec.plan_kv_decode(8, 8, 96, 120, 4).body == "v8"
    assert spec.plan_kv_decode(8, 12, 96, 64).split == 1
    long = spec.plan_kv_decode(8, 12, 2048, 64)
    assert long.split > 1 and long.warps == 8
    assert spec.plan_kv_decode(8, 12, 4096, 64).split > 1
    with pytest.raises(spec.KernelSpecError, match="no plan"):
        spec.plan_kv_decode(8, 12, 96, 20)


def test_kv_smem_counts_the_paged_ring():
    """The paged entry keeps its page numbers beside each warp's ring (3
    tiles of 3 entries at page size 16, 48 bytes aligned) and no kpos; the
    8-byte body's K rows are not padded, so hd 120 (2 * 120 + 0 bytes a
    slot) and hd 112 (2 * 112 + 16) have stages of one size."""
    dense, paged = spec.kv_smem(1, 64, 4), spec.kv_smem(1, 64, 4, 16)
    assert dense - paged == 4 * (2 * spec.KV_TILE * 4 - 48)
    q_rows = 4 * (120 - 112) * 4
    assert spec.kv_smem(4, 120, 4) - spec.kv_smem(4, 112, 4) == q_rows
