"""The tensor-core body of the packed matmuls (``csrc/qmatmul.cu``:
``qmm_short_kernel``, ``qmm_wide_kernel``), modelled on the CPU, and its
launch plan (``spec.plan_qmatmul``).

The CUDA kernels cannot run here, so this file models their arithmetic in
plain torch, with the same inputs (made with numpy from a seed) going
through the JAX package:

- the short tile (TF32, two passes): x = hi + lo, hi Veltkamp's split of x
  to 11 significant bits (exact in TF32; f32 operations, C = 2^13 + 1),
  lo = x - hi (exact) truncated to TF32 by masking its low 13 bits, as the
  kernel hands it to the MMA;
- the wide tile (bf16, three passes): x = h1 + h2 + h3, each the upper
  16 bits of the remaining f32 residual;
- the codes enter exactly (|code| <= 128 is exact in TF32 and bf16);
- the short tile's k-permutation: within each k-unit (8 k, 16 for W2) the
  A values a thread loads and the B values it decodes from packed bytes
  are paired by the fragment maps below, which mirror the kernel's index
  formulas (the wide tile keeps the natural k order);
- each scale group's partial sum is scaled, never the codes.

Products of TF32 values are exact, so the model sums them in float64;
the tensor cores' f32 accumulation is not modelled. The model is held
against the Pallas kernels in interpret mode where the shapes tile (the
JAX ops pad as they do on the TPU) and against JAX's ``qmatmul_ref`` /
``qmm_grouped_dense_ref`` for ragged M, N and K, at 1e-4 * max|ref| + 1e-5,
the limit every kernel-vs-plain check on the card uses: the split's error
is below 2^-21 |x| per product (checked here against exact float64
products), far inside it, and the rest is f32 summation order in JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul import ops as jops
from repro.kernels.qmatmul import ref as jref
from repro_torch.core.quantizer import pack_int, unpack_int
from repro_torch.kernels import spec
from torch_threads import one_torch_thread  # noqa: F401


def tol(ref) -> float:
    return 1e-4 * float(np.abs(np.asarray(ref)).max()) + 1e-5


def case(bits, k, n, g, m, e=None, seed=0):
    """Numpy inputs: x (m, k) f32 (or (e, m, k)), packed codes along K,
    scales (g, n) (or (e, g, n))."""
    rng = np.random.default_rng(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    lead = () if e is None else (e,)
    codes = rng.integers(lo, hi + 1, size=(*lead, k, n)).astype(np.int8)
    wp = pack_int(torch.from_numpy(codes), bits, axis=-2).numpy()
    s = rng.uniform(0.005, 0.02, size=(*lead, g, n)).astype(np.float32)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    return x, wp, s


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split_tf32: hi = Veltkamp's split of x (f32), lo = x -
    hi with its low 13 bits cleared."""
    c = x * 8193.0
    hi = c - (c - x)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def bf16_split(x: torch.Tensor) -> list[torch.Tensor]:
    """The wide tile's split: three upper halves of the f32 residuals."""
    parts, r = [], x
    for _ in range(3):
        h = (r.view(torch.int32) & -65536).view(torch.float32)
        parts.append(h)
        r = r - h
    return parts


def unit_of(bits: int) -> int:
    return spec.qmm_tc_unit(bits)


def a_k(bits: int, t: int, slot: int, sub: int) -> int:
    """Physical k (within its k-unit) of the A register that thread t
    gives MMA ``sub`` as logical k = t + 4 * slot: the kernel loads x at
    column t * unit/4 as a float2 (float4 for W2) and hands out its values
    in order (va[2 * sub + slot])."""
    return t * (unit_of(bits) // 4) + 2 * sub + slot


def b_k(bits: int, t: int, slot: int, sub: int) -> int:
    """Physical k of the B register that thread t decodes for MMA ``sub``
    at logical k = t + 4 * slot: W8 reads packed rows 2t and 2t + 1 (one
    byte per k), W4 both nibbles of row t, W2 fields 2 sub, 2 sub + 1 of
    row t."""
    if bits == 8:
        row, field, per = 2 * t + slot, 0, 1
    elif bits == 4:
        row, field, per = t, slot, 2
    else:
        row, field, per = t, 2 * sub + slot, 4
    return row * per + field


def unit_order(bits: int) -> list[int]:
    """Physical k of a k-unit in the order the short tile's MMAs take it."""
    return [a_k(bits, t, slot, sub) for sub in range(unit_of(bits) // 8)
            for slot in range(2) for t in range(4)]


def tc_model(x, wp, s, bits, tile="short") -> np.ndarray:
    """The tensor-core body's arithmetic: x (M, K) f32 @ codes (K, N) with
    (G, N) scales -> (M, N) f32."""
    xt = torch.from_numpy(x)
    k = xt.shape[1]
    codes = unpack_int(torch.from_numpy(wp), bits, k).to(torch.float64)
    g_rows = s.shape[0]
    group = k // g_rows
    if tile == "short":
        hi, lo = tf32_split(xt)
        a = hi.double() + lo.double()  # products of TF32 values are exact
        unit = unit_of(bits)
    else:
        a = sum(h.double() for h in bf16_split(xt))  # and of bf16 values
        unit = spec.QMM_WIDE_UNIT
    pad = -k % unit  # the kernel's zero fill past K
    a = torch.nn.functional.pad(a, (0, pad))
    codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    if tile == "short":  # the k-permutation, unit by unit
        order = torch.tensor(unit_order(bits))
        idx = (torch.arange(0, k + pad, unit)[:, None] + order[None, :]).reshape(-1)
        a, codes = a[:, idx], codes[idx]
        kk = idx
    else:
        kk = torch.arange(k + pad)
    out = torch.zeros((xt.shape[0], codes.shape[1]), dtype=torch.float64)
    for g in range(g_rows):  # each group's partial sum, then its scale
        sel = (kk // group) == g
        out += (a[:, sel] @ codes[sel]) * torch.from_numpy(s[g]).double()
    return out.float().numpy()


def exact(x, wp, s, bits) -> np.ndarray:
    k = x.shape[1]
    codes = unpack_int(torch.from_numpy(wp), bits, k).double()
    w = codes.reshape(s.shape[0], k // s.shape[0], -1) * torch.from_numpy(s).double()[:, None]
    return (torch.from_numpy(x).double() @ w.reshape(k, -1)).numpy()


def check_split_bound(got, x, wp, s, bits):
    """|model - exact| <= 2^-21 * sum_k |x| |code| s (plus float32 output
    rounding): the split's error bound."""
    k = x.shape[1]
    codes = unpack_int(torch.from_numpy(wp), bits, k).double().abs().numpy()
    w = (codes.reshape(s.shape[0], k // s.shape[0], -1) * s[:, None]).reshape(k, -1)
    bound = 2.0 ** -21 * (np.abs(x).astype(np.float64) @ w)
    want = exact(x, wp, s, bits)
    assert np.all(np.abs(got - want) <= bound + 2.0 ** -23 * np.abs(want) + 1e-30)


# --- the fragment maps and the split ----------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k_permutation_pairs_a_and_b(bits):
    """A and B of every register take the same physical k, and a k-unit's
    k are each taken once."""
    for sub in range(unit_of(bits) // 8):
        for slot in range(2):
            for t in range(4):
                assert a_k(bits, t, slot, sub) == b_k(bits, t, slot, sub)
    assert sorted(unit_order(bits)) == list(range(unit_of(bits)))
    # both k of a thread's B fragment come from one packed byte (W4, W2)
    if bits != 8:
        per = 8 // bits
        for sub in range(unit_of(bits) // 8):
            for t in range(4):
                assert b_k(bits, t, 0, sub) // per == b_k(bits, t, 1, sub) // per


def test_column_map_is_a_bijection():
    """Byte i of the 32-bit word at column 4g feeds n8 tile i's column g;
    the accumulator c of thread (g, t) in tile i is then column 8t + 4(c&1)
    + i, so a thread's accumulators are 8 consecutive columns."""
    b_cols = {(i, g): 4 * g + i for i in range(4) for g in range(8)}
    assert sorted(b_cols.values()) == list(range(32))
    for t in range(4):
        cols = set()
        for i in range(4):
            for c in range(2):
                logical = 2 * t + c  # C layout: column 2t + c of the n8 tile
                cols.add(b_cols[(i, logical)])
                assert b_cols[(i, logical)] == 8 * t + 4 * c + i
        assert cols == set(range(8 * t, 8 * t + 8))


@pytest.mark.parametrize("tile", ["short", "wide"])
def test_split_is_exact_in_its_type_and_bounded(tile):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096), rng.standard_normal(512) * 1e-30,
                        rng.standard_normal(512) * 1e30, [0.0, -0.0, 1.0, -3.0]])
    x = torch.from_numpy(x.astype(np.float32))
    parts = tf32_split(x) if tile == "short" else bf16_split(x)
    low = 0x1FFF if tile == "short" else 0xFFFF  # bits that TF32 / bf16 do not keep
    for h in parts:
        assert torch.equal(h.view(torch.int32) & low, torch.zeros_like(x, dtype=torch.int32))
    err = (x.double() - sum(h.double() for h in parts)).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


# --- the model against the JAX package ----------------------------------------

@pytest.mark.parametrize("tile", ["short", "wide"])
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tc_model_matches_jax_pallas(bits, group, tile):
    """Shapes that tile: the Pallas qmatmul (interpret mode, through the
    JAX ops' padding) and JAX's qmatmul_ref."""
    k, n, m = 256, 256, 32 if tile == "short" else 64
    x, wp, s = case(bits, k, n, 1 if group is None else k // group, m, seed=bits)
    got = tc_model(x, wp, s, bits, tile)
    jqw = jops.QuantizedLinear(jnp.asarray(wp), jnp.asarray(s), bits, k)
    want = np.asarray(jops.qmm(jnp.asarray(x), jqw, backend="pallas"))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(want))
    want_ref = np.asarray(jref.qmatmul_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s),
                                           bits))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=tol(want_ref))
    check_split_bound(got, x, wp, s, bits)


# (bits, k, n, g, m): ragged K (int8 K 100, W4 K 98, W2 K 100), ragged N and M,
# groups of 8 and 16 (a whole number of k-units)
RAGGED = [(8, 100, 48, 1, 9), (4, 98, 77, 1, 33), (2, 100, 40, 1, 17),
          (4, 64, 200, 8, 65), (2, 96, 7, 6, 1), (8, 64, 1, 4, 520)]


@pytest.mark.parametrize("bits,k,n,g,m", RAGGED)
def test_tc_model_matches_jax_ragged(bits, k, n, g, m):
    x, wp, s = case(bits, k, n, g, m, seed=k + n)
    want = np.asarray(jref.qmatmul_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s), bits))
    for tile in ("short", "wide"):
        got = tc_model(x, wp, s, bits, tile)
        assert got.shape == (m, n)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol(want))
        check_split_bound(got, x, wp, s, bits)


@pytest.mark.parametrize("bits,group,m", [(4, None, 9), (2, 32, 64), (8, None, 64)])
def test_tc_model_grouped_matches_jax(bits, group, m):
    """Stacked experts: the model per expert against the Pallas
    qmatmul_grouped (interpret mode) and JAX's qmm_grouped_dense_ref."""
    e, k, n = 3, 128, 96
    x, wp, s = case(bits, k, n, 1 if group is None else k // group, m, e=e, seed=m)
    tile = "short" if m <= spec.QMM_SHORT_M else "wide"
    got = np.stack([tc_model(x[i], wp[i], s[i], bits, tile) for i in range(e)])
    want = np.asarray(jref.qmm_grouped_dense_ref(jnp.asarray(x), jnp.asarray(wp),
                                                 jnp.asarray(s), bits))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(want))
    jqw = jops.QuantizedLinear(jnp.asarray(wp), jnp.asarray(s), bits, k)
    want_k = np.asarray(jops.qmm(jnp.asarray(x), jqw, backend="pallas"))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=tol(want_k))


# --- the plan -------------------------------------------------------------------

# (M, K, N, bits, E, grouped): the main path's tiled calls. brecq-lm-100m's
# three linear shapes at the engine's prefill chunk (32 rows) and the fixed
# batch's prefill (512), W4 and W2; deepseek-moe-16b's routed experts at the
# fixed-batch prefill (64 rows per expert, E 64).
MAIN_PATH = ([(m, k, n, b, 1, False) for m in (32, 512) for b in (4, 2)
              for (k, n) in ((768, 768), (768, 2048), (2048, 768))]
             + [(64, k, n, 4, 64, True) for (k, n) in ((2048, 1408), (1408, 2048))])


@pytest.mark.parametrize("M,K,N,bits,E,grouped", MAIN_PATH)
def test_plan_main_path_takes_tensor_cores_and_fills_the_card(M, K, N, bits, E, grouped):
    p = spec.plan_qmatmul(M, K, N, 1, bits, E, grouped)
    assert p.body == "tc"
    assert p.tile == ("short" if M <= spec.QMM_SHORT_M else "wide")
    assert p.arith == spec.QMM_TC_ARITH[p.tile]
    assert p.smem <= spec.SMEM_PER_BLOCK
    assert p.blocks >= spec.SM_COUNT
    assert p.blocks == p.grid[0] * p.grid[1] * p.grid[2]
    assert p.grid == (-(-N // p.bn), -(-M // p.bm), E * p.split)
    assert p.split in (1, 2, 4, 8) and p.split * spec.QMM_TC_BK <= K


@pytest.mark.parametrize("bits,group", [(4, 4), (4, 2), (2, 8), (2, 4)])
def test_plan_groups_shorter_than_a_k_unit_take_cuda_cores(bits, group):
    """A scale group must be a whole number of k-units (8 k, 16 for W2)."""
    assert spec.plan_qmatmul(64, 128, 64, 128 // group, bits).body == "simt"
    assert spec.plan_qmatmul(9, 128, 64, 128 // group, bits, 4, True).body == "simt"
    ok = spec.qmm_tc_unit(bits)
    assert spec.plan_qmatmul(64, 128, 64, 128 // ok, bits).body == "tc"


@pytest.mark.parametrize("bits,group,tile", [(4, 8, "short"), (8, 8, "short"), (4, 16, "wide"),
                                             (2, 16, "wide"), (4, 128, "wide")])
def test_plan_wide_tile_takes_groups_of_16_k(bits, group, tile):
    """The wide tile folds scales every 16 k; groups of 8 above 32 rows take
    the short tile."""
    p = spec.plan_qmatmul(64, 256, 128, 256 // group, bits)
    assert (p.body, p.tile) == ("tc", tile)


def test_plan_is_a_function_of_the_shape():
    args = [(32, 768, 768, 1, 4), (512, 768, 2048, 6, 2), (64, 2048, 1408, 1, 4, 64, True)]
    first = [spec.plan_qmatmul(*a) for a in args]
    spec.plan_qmatmul.cache_clear()
    assert [spec.plan_qmatmul(*a) for a in args] == first


def test_plan_grouped_decode_rows_take_the_gemv_body():
    for m in (1, 8):
        p = spec.plan_qmatmul(m, 2048, 1408, 1, 4, 64, True)
        assert p.body == "gemv_tc" and p.blocks == 11 * 64
    assert spec.plan_qmatmul(8, 2048, 1408, 1, 4).body == "tc"  # qmatmul itself: any M


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plan_shared_memory_fits_a_block(bits):
    for tile in spec.QMM_TC_TILES:
        assert 0 < spec.qmm_tc_smem(bits, tile) <= spec.SMEM_PER_BLOCK
