"""The tensor-core decode body of the packed matmuls (``csrc/qmatmul.cu``:
``qgemv_tc_kernel``, which runs ``qgemv`` and ``qmatmul_grouped`` at M <= 8),
modelled on the CPU, its launch plan (``spec.plan_qgemv``), and the head dims
``kv_decode`` takes (``spec.describe_kv_decode``).

The CUDA kernel cannot run here, so this file models its arithmetic with the
same inputs (made with numpy from a seed) going through the JAX package:

- the operands are swapped, out^T = W^T x^T, one mma.sync.m16n8k16 bf16 per
  16 weight columns x 16 k: A holds codes, B holds x^T with the batch rows
  as its 8 columns;
- the fragment maps below mirror the kernel's index formulas: which packed
  row and field of a 16-k unit each A register half takes, which x each B
  register half takes, and which weight column each MMA row is (thread
  (g, t) reads a piece of P bytes at column P*g; tile j gives row g to
  column P*g + 2j and row g + 8 to P*g + 2j + 1);
- codes enter as the kernel builds them, through the bf16 bit patterns of
  its unpacking (exact: |code| <= 128);
- x is split in three bf16 parts (the upper halves of the f32 residuals);
- each scale group's partial sum is scaled, never the codes.

Products of bf16 values are exact, so the model sums them in float64; the
tensor cores' f32 accumulation is not modelled. The model is held against
the Pallas ``qgemv`` / ``qmatmul_grouped`` in interpret mode (through the
JAX ops, which pad as they do on the TPU) and JAX's references, at 1e-4 *
max|ref| + 1e-5, the limit every kernel-vs-plain check on the card uses.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spec as jspec
from repro.kernels.kvattn.kernel import kv_decode as j_kv_decode
from repro.kernels.qmatmul import ops as jops
from repro.kernels.qmatmul import ref as jref
from repro_torch.core.quantizer import pack_int, unpack_int
from repro_torch.kernels import spec
from repro_torch.kernels.kvattn.ops import quantize_kv
from repro_torch.kernels.kvattn.ref import kv_decode_ref
from torch_threads import one_torch_thread  # noqa: F401


UNIT = spec.QMM_DEC_UNIT
PIECE = {"dec16": 2, "dec128": 16}  # bytes of a packed row a thread reads: columns = 8 x piece


def tol(ref) -> float:
    return 1e-4 * float(np.abs(np.asarray(ref)).max()) + 1e-5


def case(bits, k, n, g, m, e=None, seed=0):
    """Numpy inputs: x (m, k) f32 (or (e, m, k)), codes packed along K,
    scales (g, n) (or (e, g, n))."""
    rng = np.random.default_rng(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    lead = () if e is None else (e,)
    codes = rng.integers(lo, hi + 1, size=(*lead, k, n)).astype(np.int8)
    wp = pack_int(torch.from_numpy(codes), bits, axis=-2).numpy()
    s = rng.uniform(0.005, 0.02, size=(*lead, g, n)).astype(np.float32)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    return x, wp, s


# --- the fragment maps (the kernel's index formulas) ------------------------

def a_source(bits: int, t: int, pair: int, half: int) -> tuple[int, int]:
    """(packed row within the 16-k unit, field) whose code thread t puts in
    half ``half`` of the A register of k-pair ``pair`` (a0/a1: pair 0, logical
    k 2t + half; a2/a3: pair 1, logical k 2t + 8 + half): W4 reads packed
    rows t and t + 4 (both nibbles), W2 row t (fields 0, 1 and 2, 3), W8 rows
    t, t + 4, t + 8, t + 12."""
    if bits == 4:
        return t + 4 * pair, half
    if bits == 2:
        return t, 2 * pair + half
    return t + 4 * (2 * pair + half), 0


def b_source(bits: int, t: int, pair: int, half: int) -> int:
    """k within the unit of the x value that thread t puts in half ``half``
    of B register ``pair``: the kernel loads v[0..3] (float2 at 2t and 2t +
    8 for W4, float4 at 4t for W2, floats at t + 4i for W8) and packs v[2 *
    pair + half]."""
    i = 2 * pair + half
    if bits == 4:
        return (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)[i]
    if bits == 2:
        return 4 * t + i
    return t + 4 * i


def a_k(bits: int, t: int, pair: int, half: int) -> int:
    row, field = a_source(bits, t, pair, half)
    return row * (8 // bits) + field


def logical_k(t: int, pair: int, half: int) -> int:
    """The m16n8k16 fragment position: a0/b0 hold k 2t, 2t + 1; a2/b1 hold
    2t + 8, 2t + 9."""
    return 2 * t + half + 8 * pair


THREAD_K = [(t, pair, half) for t in range(4) for pair in range(2) for half in range(2)]


def column(piece: int, g: int, j: int, h: int) -> int:
    """Weight column (within the block) of MMA row g + 8h of tile j."""
    return piece * g + 2 * j + h


# --- the kernel's unpacking to bf16 ------------------------------------------

def bf16_values(word: np.ndarray) -> np.ndarray:
    """The two bf16 halves of uint32 words as float32 (low half first)."""
    w = word.astype(np.uint32)
    lo = (w << 16).view(np.float32)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32)
    return np.stack([lo, hi], -1)


def bf16_pair(fields: np.ndarray, bias: int) -> np.ndarray:
    """``sub.rn.bf16x2 (fields | 0x43004300), bias``: exact here (small
    integers), returned as float32 pairs, checked to be bf16 values."""
    got = bf16_values(fields | np.uint32(0x43004300)) - bf16_values(np.uint32(bias))
    assert np.all((got.view(np.uint32) & 0xFFFF) == 0)
    return got


def spread(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``__byte_perm(lo, hi, ...)`` as the kernel uses it: a byte of ``lo``
    at bits 0..7 and the same byte of ``hi`` at bits 16..23."""
    return (lo & np.uint32(0xFF)) | ((hi & np.uint32(0xFF)) << np.uint32(16))


def a_pair(bits: int, byte: np.ndarray, pair: int, byte2: np.ndarray = None) -> np.ndarray:
    """The A register (two codes, the lower k first) that the kernel builds
    from packed byte(s) of one column: the byte and its copy shifted by one
    field (W4: >> 4; W2: >> 4 pair and >> 4 pair + 2) spread to bits 0 and 16,
    masked to the fields, minus the offset in bf16; W8 the upper halves of
    the exact f32 codes of two bytes (rows of the pair)."""
    byte = byte.astype(np.uint32)
    if bits == 4:
        return bf16_pair(spread(byte, byte >> np.uint32(4)) & np.uint32(0x000F000F), 0x43084308)
    if bits == 2:
        lo, hi = byte >> np.uint32(4 * pair), byte >> np.uint32(4 * pair + 2)
        return bf16_pair(spread(lo, hi) & np.uint32(0x00030003), 0x43024302)
    out = []
    for b in (byte, byte2.astype(np.uint32)):
        f = (np.uint32(0x4B000000) | (b ^ np.uint32(0x80))).view(np.float32) - np.float32(8388736.0)
        assert np.all((f.view(np.uint32) & 0xFFFF) == 0)
        out.append(f)
    return np.stack(out, -1)


def bf16_split(x: np.ndarray) -> list[np.ndarray]:
    """x = h1 + h2 + h3, each the upper 16 bits of the remaining residual."""
    parts, r = [], x.astype(np.float32)
    for _ in range(3):
        h = (r.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        parts.append(h)
        r = (r - h).astype(np.float32)
    return parts


# --- the body's arithmetic -----------------------------------------------------

def dec_model(x, wp, s, bits, tile) -> np.ndarray:
    """The decode body: x (M <= 8, K) f32 @ codes (K*bits/8, N) with (G, N)
    scales -> (M, N) f32, built register by register from the fragment
    maps and the kernel's unpacking, each 16-k unit's MMAs summed exactly."""
    piece = PIECE[tile]
    bn = 8 * piece
    m, k = x.shape
    n = wp.shape[1]
    g_rows = s.shape[0]
    units = -(-k // UNIT)
    rows_u = 2 * bits
    n_pad = -(-n // bn) * bn
    codes = np.zeros((units * rows_u, n_pad), np.uint8)  # the kernel's zero fill
    codes[:wp.shape[0], :n] = wp.view(np.uint8)
    xp = np.zeros((8, units * UNIT), np.float32)
    xp[:m, :k] = x
    parts = bf16_split(xp)
    # B[lv][u][logical k][n]
    b = np.zeros((3, units, UNIT, 8))
    for (t, pair, half) in THREAD_K:
        kk = np.arange(units) * UNIT + b_source(bits, t, pair, half)
        for lv in range(3):
            b[lv, :, logical_k(t, pair, half), :] = parts[lv][:, kk].T
    # A[u][column][logical k]: per thread (g, t), tile j, row half h
    a = np.zeros((units, n_pad, UNIT))
    for strip in range(n_pad // bn):
        for g in range(8):
            for j in range(piece // 2):
                for h in range(2):
                    col = strip * bn + column(piece, g, j, h)
                    for (t, pair, half) in THREAD_K:
                        if half:
                            continue
                        row, _ = a_source(bits, t, pair, 0)
                        prow = np.arange(units) * rows_u + row
                        if bits == 8:
                            row2, _ = a_source(bits, t, pair, 1)
                            val = a_pair(8, codes[prow, col], pair,
                                         codes[np.arange(units) * rows_u + row2, col])
                        else:
                            val = a_pair(bits, codes[prow, col], pair)
                        a[:, col, logical_k(t, pair, 0)] = val[:, 0]
                        a[:, col, logical_k(t, pair, 1)] = val[:, 1]
    # D_u = A_u @ B_u per pass, summed exactly; scales per group
    d = np.einsum("uck,lukn->ucn", a, b)  # (units, columns, 8)
    group_units = (k // g_rows) // UNIT
    out = np.zeros((n_pad, 8))
    for grp in range(g_rows):
        sl = slice(grp * group_units, (grp + 1) * group_units) if g_rows > 1 else slice(None)
        scale = np.zeros(n_pad)
        scale[:n] = s[grp]
        out += d[sl].sum(0) * scale[:, None]
    return out.T[:m, :n].astype(np.float32)


def exact(x, wp, s, bits) -> np.ndarray:
    k = x.shape[1]
    codes = unpack_int(torch.from_numpy(wp), bits, k).double()
    w = codes.reshape(s.shape[0], k // s.shape[0], -1) * torch.from_numpy(s).double()[:, None]
    return (torch.from_numpy(x).double() @ w.reshape(k, -1)).numpy()


def check_split_bound(got, x, wp, s, bits):
    """|model - exact| <= 2^-21 * sum_k |x| |code| s (plus f32 output
    rounding): the split's error bound."""
    k = x.shape[1]
    codes = unpack_int(torch.from_numpy(wp), bits, k).double().abs().numpy()
    w = (codes.reshape(s.shape[0], k // s.shape[0], -1) * s[:, None]).reshape(k, -1)
    bound = 2.0 ** -21 * (np.abs(x).astype(np.float64) @ w)
    want = exact(x, wp, s, bits)
    assert np.all(np.abs(got - want) <= bound + 2.0 ** -23 * np.abs(want) + 1e-30)


# --- the maps and the unpacking ------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fragment_maps_pair_each_code_with_its_x(bits):
    """A and B of every register half take the same physical k, and a unit's
    16 k are each taken once, in logical and in physical order."""
    for (t, pair, half) in THREAD_K:
        assert a_k(bits, t, pair, half) == b_source(bits, t, pair, half)
    assert sorted(a_k(bits, *th) for th in THREAD_K) == list(range(UNIT))
    assert sorted(logical_k(*th) for th in THREAD_K) == list(range(UNIT))
    # the rows a thread reads are the unit's packed rows, each by one t
    rows = {a_source(bits, *th)[0] for th in THREAD_K}
    assert rows == set(range(2 * bits))


@pytest.mark.parametrize("tile", ["dec16", "dec128"])
def test_column_and_accumulator_maps_are_bijections(tile):
    piece = PIECE[tile]
    bn = spec.QMM_DEC_TILES[tile][0]
    assert bn == 8 * piece
    cols = [column(piece, g, j, h) for g in range(8) for j in range(piece // 2) for h in range(2)]
    assert sorted(cols) == list(range(bn))
    # accumulator c of thread (g, t) in tile j: row g + 8 (c >= 2), batch row 2t + (c & 1)
    outs = [(column(piece, g, j, c >> 1), 2 * t + (c & 1))
            for g in range(8) for t in range(4) for j in range(piece // 2) for c in range(4)]
    assert sorted(outs) == [(c, n) for c in range(bn) for n in range(8)]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpacking_gives_the_codes_exactly(bits):
    """Every packed byte decodes, through the kernel's bf16 bit patterns,
    to the codes ``unpack_int`` reads from it."""
    byte = np.arange(256, dtype=np.uint8)
    per = 8 // bits
    packed = torch.from_numpy(byte.view(np.int8)[:, None].copy())
    want = unpack_int(packed, bits, 256 * per).numpy().reshape(256, per)
    if bits == 8:
        got = a_pair(8, byte, 0, byte[::-1].copy())
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_array_equal(got[:, 1], want[::-1, 0])
        return
    for pair in range(per // 2):
        np.testing.assert_array_equal(a_pair(bits, byte, pair), want[:, 2 * pair:2 * pair + 2])


def test_split_is_exact_in_bf16_and_bounded():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096), rng.standard_normal(512) * 1e-30,
                        rng.standard_normal(512) * 1e30, [0.0, -0.0, 1.0, -3.0]])
    x = x.astype(np.float32)
    parts = bf16_split(x)
    for h in parts:
        assert np.all((h.view(np.uint32) & 0xFFFF) == 0)
    err = np.abs(x.astype(np.float64) - sum(h.astype(np.float64) for h in parts))
    assert np.all(err <= 2.0 ** -21 * np.abs(x.astype(np.float64)))


# --- the model against the JAX package ----------------------------------------

@pytest.mark.parametrize("tile", ["dec16", "dec128"])
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_model_matches_jax_qgemv(bits, group, tile):
    """M 1..8: the Pallas qgemv (interpret mode, through the JAX ops'
    decode tier) at M 1, 5, 8 and JAX's qgemv_ref at every M."""
    k, n = 256, 256
    g = 1 if group is None else k // group
    for m in range(1, 9):
        x, wp, s = case(bits, k, n, g, m, seed=10 * bits + m)
        got = dec_model(x, wp, s, bits, tile)
        want = np.asarray(jref.qgemv_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s), bits))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol(want))
        check_split_bound(got, x, wp, s, bits)
        if m in (1, 5, 8):
            jqw = jops.QuantizedLinear(jnp.asarray(wp), jnp.asarray(s), bits, k)
            want_k = np.asarray(jops.qmm(jnp.asarray(x), jqw, backend="pallas"))
            np.testing.assert_allclose(got, want_k, rtol=0, atol=tol(want_k))


# (bits, k, n, g, m): ragged N (200, 77, 7), ragged K (int8 K 100, W4 K 98), groups of 16
RAGGED = [(4, 256, 200, 1, 8), (2, 128, 77, 1, 3), (8, 100, 7, 1, 8), (4, 98, 40, 1, 1),
          (4, 128, 96, 8, 6), (2, 64, 33, 4, 8)]


@pytest.mark.parametrize("bits,k,n,g,m", RAGGED)
def test_model_matches_jax_ragged(bits, k, n, g, m):
    x, wp, s = case(bits, k, n, g, m, seed=k + n)
    want = np.asarray(jref.qgemv_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s), bits))
    jqw = jops.QuantizedLinear(jnp.asarray(wp), jnp.asarray(s), bits, k)
    want_k = np.asarray(jops.qmm(jnp.asarray(x), jqw, backend="pallas"))
    for tile in PIECE:
        got = dec_model(x, wp, s, bits, tile)
        assert got.shape == (m, n)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol(want))
        np.testing.assert_allclose(got, want_k, rtol=0, atol=tol(want_k))
        check_split_bound(got, x, wp, s, bits)


@pytest.mark.parametrize("bits,group,m", [(4, None, 8), (2, 32, 1), (8, None, 5), (4, 64, 3)])
def test_model_grouped_matches_jax(bits, group, m):
    """Stacked experts (the expert on the grid, each its own decode body):
    the Pallas qmatmul_grouped (interpret mode) and JAX's qmm_grouped_ref."""
    e, k, n = 3, 128, 96
    x, wp, s = case(bits, k, n, 1 if group is None else k // group, m, e=e, seed=m)
    tile = spec.plan_qgemv(k, n, s.shape[1], bits, e).tile
    got = np.stack([dec_model(x[i], wp[i], s[i], bits, tile) for i in range(e)])
    want = np.asarray(jref.qmm_grouped_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s), bits))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(want))
    jqw = jops.QuantizedLinear(jnp.asarray(wp), jnp.asarray(s), bits, k)
    want_k = np.asarray(jops.qmm(jnp.asarray(x), jqw, backend="pallas"))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=tol(want_k))


# --- the plan --------------------------------------------------------------------

def test_plan_does_not_depend_on_m():
    assert "M" not in inspect.signature(spec.plan_qgemv).parameters
    for (k, n, g, bits, e) in [(768, 768, 1, 4, 1), (2048, 1408, 1, 4, 64), (256, 96, 16, 2, 3),
                               (128, 64, 16, 4, 4)]:
        plans = {spec.plan_qmatmul(m, k, n, g, bits, e, True) for m in range(1, 9)}
        assert plans == {spec.plan_qgemv(k, n, g, bits, e)}


# (K, N, bits, E): brecq-lm-100m's decode matmuls (qgemv) at W4 and W2, and
# deepseek-moe-16b's routed experts at decode (E 64)
DECODE_MAIN_PATH = ([(k, n, b, 1) for b in (4, 2) for (k, n) in ((768, 768), (768, 2048),
                                                                  (2048, 768))]
                    + [(2048, 1408, 4, 64), (1408, 2048, 4, 64)])


@pytest.mark.parametrize("K,N,bits,E", DECODE_MAIN_PATH)
def test_plan_main_path_takes_the_tensor_core_body(K, N, bits, E):
    for g in (1, K // 128):
        p = spec.plan_qgemv(K, N, g, bits, E)
        assert (p.body, p.arith) == ("gemv_tc", "bf16x3")
        assert p.tile == ("dec16" if E == 1 else "dec128")
        bn, warps, slots = spec.QMM_DEC_TILES[p.tile]
        assert (p.bn, p.split, p.stages, p.threads) == (bn, warps, slots, 32 * warps)
        assert p.grid == (-(-N // bn), E, 1) and p.blocks == p.grid[0] * E
        assert p.smem == spec.qmm_dec_smem(bits, p.tile) <= spec.SMEM_PER_BLOCK
        # qgemv's warps hold every unit of their share of K in flight
        assert E > 1 or -(-K // (spec.QMM_DEC_UNIT * warps)) <= slots - 1
    assert E == 1 or spec.plan_qgemv(K, N, 1, bits, E).blocks >= spec.SM_COUNT


@pytest.mark.parametrize("bits,group", [(4, 8), (2, 8), (8, 8), (4, 4), (2, 4)])
def test_plan_short_groups_take_cuda_cores(bits, group):
    """A scale group must be a whole number of 16-k units."""
    for e in (1, 4):
        p = spec.plan_qgemv(256, 96, 256 // group, bits, e)
        assert (p.body, p.arith) == ("gemv", "f32")
    assert spec.plan_qgemv(256, 96, 256 // 16, bits, 1).body == "gemv_tc"


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plan_shared_memory_fits_a_block(bits):
    for tile, (bn, warps, slots) in spec.QMM_DEC_TILES.items():
        smem = spec.qmm_dec_smem(bits, tile)
        assert warps * 8 * (bn + 4) * 4 <= smem <= spec.SMEM_PER_BLOCK


# --- kv_decode's head dims: multiples of 8 that are not of 16 -------------------

def test_describe_kv_decode_accepts_head_dim_120_as_jax_does():
    """h2o-danube3-4b's head dim 120 with G 4: JAX's spec takes it, and so
    does the port's, on the 8-byte body; hd 64 keeps the 16-byte body."""
    for b in (1, 8):
        jspec.describe_kv_decode((b, 32, 120), (b, 96, 8, 120), bs=96)
        sp = spec.describe_kv_decode((b, 32, 120), (b, 96, 8, 120))
        assert (sp["G"], sp["hd"], sp["body"]) == (4, 120, "v8")
    assert spec.describe_kv_decode((8, 12, 64), (8, 96, 12, 64))["body"] == "v16"
    assert [spec.kv_decode_body(hd) for hd in (16, 24, 112, 120, 128, 256)] == \
        ["v16", "v8", "v16", "v8", "v16", "v16"]


def test_describe_kv_decode_rejects_head_dims_off_8():
    for hd in (20, 66, 121):
        with pytest.raises(spec.KernelSpecError, match="multiple of 8"):
            spec.describe_kv_decode((2, 8, hd), (2, 96, 2, hd))


@pytest.mark.parametrize("window,holes", [(None, False), (48, True)])
def test_kv_decode_plain_at_head_dim_120_matches_jax(window, holes):
    rng = np.random.default_rng(120)
    B, H, K, hd, S = 2, 16, 4, 120, 96
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k8, v8, ks, vs = quantize_kv(torch.from_numpy(rng.standard_normal((B, S, K, hd)).astype(np.float32)),
                                 torch.from_numpy(rng.standard_normal((B, S, K, hd)).astype(np.float32)))
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if holes:
        kpos[rng.random((B, S)) < 0.3] = -1
    cur = np.array([S - 1, S // 2], np.int32)
    got = kv_decode_ref(torch.from_numpy(q), k8, v8, ks, vs, torch.from_numpy(kpos),
                        torch.from_numpy(cur), window).numpy()
    want = np.asarray(j_kv_decode(jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
                                  jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
                                  jnp.asarray(kpos), jnp.asarray(cur), window=window, bs=S,
                                  interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
