"""Shape contracts of the CUDA kernels, with typed errors.

The port of the JAX package's ``repro.kernels.spec`` shape and
divisibility checks. The TPU's VMEM budget and block divisibility do not
carry over: the CUDA kernels mask ragged M and N, and a ragged cache
length S, themselves. What stays is the packing contract (K = packed rows
x values per byte, scales span N, each scale group a whole number of
packed rows), the GQA grouping of ``kv_decode`` (H % K == 0), and the
limits the CUDA kernels really have (decode rows, head dim, group size).

``plan_qmatmul`` and ``plan_qgemv`` are the launch plans of the packed
matmuls: body, tile, split of K, grid and shared memory per block, from
the shape alone (the decode plan not even from M), checked against the
card's per-block shared-memory budget. ``kv_decode_body`` picks
``kv_decode``'s body from the head dim.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

# The decode kernel keeps one f32 accumulator per batch row and column in
# registers; it takes at most this many rows.
QGEMV_M_MAX = 8

# kv_decode keeps the G = H/K query rows of one (batch, kv-head) and their
# f32 accumulators in one block: at most this many rows of at most
# KV_HD_MAX values, read in 16-byte vectors of int8 codes (hd % 16 == 0)
# or 8-byte ones (the other multiples of 8).
KV_G_MAX = 16
KV_HD_MAX = 256
KV_BODIES = {"v16": 16, "v8": 8}  # body -> bytes a load

# The card the plans are made for, an H100 SXM: its SMs, and the shared
# memory one block may use (227 KB). Fixed here: no run-time query, so a
# shape always gets the same plan and the same summation order.
SM_COUNT = 132
SMEM_PER_BLOCK = 232_448

# kv_decode's launch (csrc/kvattn.cu mirrors these): blocks of 4 or 8
# warps (KV_WARPS), each warp on its own tiles of KV_TILE slots (a lane
# each) through its own cp.async ring of KV_STAGES tiles, K rows padded by
# KV_KPAD[body] bytes; a block keeps at most KV_BLOCK_VALUES query values (rows * hd), so a
# kv head whose G rows hold more takes several blocks; S splits over a
# cluster of up to KV_SPLITS[-1] blocks; a lane keeps KV_UNITS float4
# accumulators.
KV_WARPS = (4, 8)
KV_TILE = 32
KV_STAGES = 2
KV_KPAD = {"v16": 16, "v8": 0}
KV_BLOCK_VALUES = 1024
KV_SPLITS = (1, 2, 4, 8)
KV_UNITS = (1, 2, 4, 8)
# A block takes 8 warps for a cache of at least KV_WIDE_TILES tiles where two
# such blocks fit an SM, else 4; S is split over a cluster until the grid
# holds KV_TARGET_BLOCKS blocks, as long as each warp keeps KV_MIN_TILES
# tiles.
KV_WIDE_TILES = 16
KV_TARGET_BLOCKS = SM_COUNT
KV_MIN_TILES = 4

# The tensor-core tiles of qmatmul / qmatmul_grouped (csrc/qmatmul.cu
# mirrors them): name -> (BM, BN, threads, ring stages). "short" (M <= 32)
# is mma.sync m16n8k8 TF32 (x in two passes), 4 warps each on every fourth
# k-unit of one 32 x 32 tile; "wide" is one warpgroup's wgmma.m64n128k16
# bf16 (x in three passes). Both take k in stages of QMM_TC_BK; K is split
# over a cluster of up to QMM_MAX_SPLIT blocks until the grid holds the
# tile's target of blocks (the short tile's blocks are small and
# latency-bound: two an SM).
QMM_TC_TILES = {"short": (32, 32, 128, 4), "wide": (64, 128, 128, 3)}
QMM_TC_ARITH = {"short": "tf32x2", "wide": "bf16x3"}
QMM_WIDE_UNIT = 16  # k a wide-tile step spans: its scale groups are a whole number of them
QMM_TC_BK = 32
QMM_SHORT_M = 32
QMM_MAX_SPLIT = 8
QMM_TARGET_BLOCKS = {"short": 2 * SM_COUNT, "wide": SM_COUNT}
# The wide tile splits further while a block keeps at least this many
# stages, up to one wave of resident blocks; a grid of more than a wave
# takes the split (of 1 and 2) whose last wave is fullest.
QMM_WIDE_MIN_STAGES = 8
# The CUDA-core bodies: qmatmul's and qmatmul_grouped's 64 x 64 tile (K
# split over a 2-block cluster for qmatmul), and the grouped decode body.
QMM_SIMT_TILE = (64, 64, 32)
QMM_SIMT_THREADS = 256
QMM_GEMV_COLS = 64
QMM_GEMV_THREADS = 256
# The tensor-core decode body of qgemv / qmatmul_grouped at M <= 8
# (mma.sync.m16n8k16 bf16, operands swapped: 16 weight columns x the batch
# rows, x in three passes): name -> (columns a block, warps splitting K,
# ring slots a warp). A slot holds one 16-k unit; its scale groups must be
# a whole number of units. "dec16" takes qgemv's narrow matrices (a block
# per 16 columns), "dec128" the stacked experts' stream.
QMM_DEC_TILES = {"dec16": (16, 16, 9), "dec128": (128, 4, 4)}
QMM_DEC_UNIT = 16


class KernelSpecError(ValueError):
    """A kernel launch's shapes violate its contract (shapes named)."""


class SmemBudgetError(KernelSpecError):
    """A plan's block asks for more shared memory than SMEM_PER_BLOCK."""


def _check(cond: bool, kernel: str, msg: str) -> None:
    if not cond:
        raise KernelSpecError(f"{kernel}: {msg}")


def _check_smem(smem: int, kernel: str) -> None:
    """Every plan's one test of its block's shared memory."""
    if smem > SMEM_PER_BLOCK:
        raise SmemBudgetError(f"{kernel}: {smem} B of shared memory per block > "
                              f"{SMEM_PER_BLOCK}")


def largest_tile(dim: int, cap: int, multiple: int = 1) -> int:
    """Largest divisor of ``dim`` that is <= ``cap`` and a multiple of
    ``multiple``; when none exists, ``min(dim, cap)`` (the caller's
    divisibility check then fails with the shapes named)."""
    for d in range(min(dim, cap), 0, -1):
        if dim % d == 0 and d % multiple == 0:
            return d
    return min(dim, cap)


def _pick_bk(kernel: str, K: int, G: int, per: int) -> tuple[int, int]:
    """(bk, nk): one scale group per k-step, or the largest <=512
    divisor per-channel."""
    bk = largest_tile(K, 512, per) if G == 1 else K // G
    _check(bk > 0 and K % bk == 0, kernel,
           f"K={K} is not a multiple of the k-tile bk={bk} "
           f"(scale groups G={G})")
    _check(bk % per == 0, kernel,
           f"k-tile bk={bk} is not a multiple of the packing factor "
           f"per={per} ({8 // per}-bit codes)")
    return bk, K // bk


def _describe(name: str, x_shape, wp_shape, scales_shape, bits: int) -> dict:
    # conditions are tested before any message is formatted: this runs on
    # every kernel launch
    if bits not in (2, 4, 8):
        raise KernelSpecError(f"{name}: container bits must be 2, 4 or 8, got {bits}")
    per = 8 // bits
    if not (len(x_shape) == 2 and len(wp_shape) == 2 and len(scales_shape) == 2):
        raise KernelSpecError(f"{name}: x {tuple(x_shape)}, codes {tuple(wp_shape)} "
                              f"and scales {tuple(scales_shape)} must all be 2-D")
    M, K = x_shape
    rows, N = wp_shape
    G = scales_shape[0]
    if rows * per != K:
        raise KernelSpecError(f"{name}: packed rows {rows} x {per} values/byte != "
                              f"K={K} (codes {tuple(wp_shape)}, x {tuple(x_shape)}, "
                              f"bits={bits})")
    if scales_shape[1] != N:
        raise KernelSpecError(f"{name}: scales {tuple(scales_shape)} do not span "
                              f"N={N} columns")
    if G < 1 or M < 1 or N < 1:
        raise KernelSpecError(f"{name}: empty launch: x {tuple(x_shape)}, codes "
                              f"{tuple(wp_shape)}, scales {tuple(scales_shape)}")
    if K % G or (K // G) % per:
        _pick_bk(name, K, G, per)  # raises, naming the group and packing factor
    return {"M": M, "K": K, "N": N, "G": G, "per": per, "group": K // G}


def describe_qmatmul(x_shape, wp_shape, scales_shape, *, bits: int) -> dict:
    """Validate a ``qmatmul`` (prefill GEMM) launch: x (M, K) @
    dequant(wp (K*bits/8, N), scales (G, N)) -> (M, N)."""
    return _describe("qmatmul", x_shape, wp_shape, scales_shape, bits)


def describe_qgemv(x_shape, wp_shape, scales_shape, *, bits: int) -> dict:
    """Validate a ``qgemv`` (decode GEMV) launch: as :func:`describe_qmatmul`
    with 1 <= M <= ``QGEMV_M_MAX`` rows."""
    sp = _describe("qgemv", x_shape, wp_shape, scales_shape, bits)
    if sp["M"] > QGEMV_M_MAX:
        raise KernelSpecError(f"qgemv: M={sp['M']} rows; the decode kernel takes "
                              f"1..{QGEMV_M_MAX}")
    return sp


def describe_qmatmul_grouped(x_shape, wp_shape, scales_shape, *, bits: int) -> dict:
    """Validate a ``qmatmul_grouped`` (stacked experts) launch: x (E, M, K)
    @ dequant(wp (E, K*bits/8, N), scales (E, G, N)) -> (E, M, N). Any M
    and N (the kernel masks them); the expert axes must agree."""
    name = "qmatmul_grouped"
    if not (len(x_shape) == 3 and len(wp_shape) == 3 and len(scales_shape) == 3):
        raise KernelSpecError(f"{name}: x {tuple(x_shape)}, codes {tuple(wp_shape)} "
                              f"and scales {tuple(scales_shape)} must all be 3-D")
    E = x_shape[0]
    _check(wp_shape[0] == E and scales_shape[0] == E and E >= 1, name,
           f"expert axes disagree: x E={E}, codes {tuple(wp_shape)}, "
           f"scales {tuple(scales_shape)}")
    sp = _describe(name, x_shape[1:], wp_shape[1:], scales_shape[1:], bits)
    sp["E"] = E
    return sp


def qmm_tc_unit(bits: int) -> int:
    """k that one thread's B fragment spans in the short tile: one packed
    byte holds both k of one m16n8k8 (W4, W8: 8) or of two (W2: 16). A
    scale group must be a whole number of these for the tensor-core body."""
    return 16 if bits == 2 else 8


def qmm_tc_smem(bits: int, tile: str) -> int:
    """Dynamic shared memory of one tensor-core block, as the kernel lays
    it out. short: the 4-stage ring (x rows of BK + 8 floats, + 16 for W2;
    packed rows of 32 bytes, 48 for W8) or the 4 warps' 32 x 36 partial
    tiles, then 32 scales. wide: the 3-stage ring (x rows of BK + 8 floats,
    packed rows of 128 bytes) or the 64 x 132 tile, then one stage's bf16 B
    tiles (BK/16 steps of 16 column groups 272 bytes apart), then 128
    scales."""
    bm, bn, threads, stages = QMM_TC_TILES[tile]
    codes = QMM_TC_BK * bits // 8  # packed rows a stage
    if tile == "short":
        stage = bm * (QMM_TC_BK + (16 if bits == 2 else 8)) * 4 + codes * (48 if bits == 8 else 32)
        return max(stages * stage, 4 * bm * (bn + 4) * 4) + bn * 4
    stage = bm * (QMM_TC_BK + 8) * 4 + codes * bn
    return (max(stages * stage, bm * (bn + 4) * 4)
            + (QMM_TC_BK // QMM_WIDE_UNIT) * (bn // 8) * 272 + bn * 4)


def qmm_dec_smem(bits: int, tile: str) -> int:
    """Dynamic shared memory of one decode-body block, as the kernel lays
    it out: every warp's ring of slots (a unit's 2 * bits packed rows of
    the block's columns, rows 160 bytes apart for 128 columns, then x's 8
    rows of 16 k at a stride of 24 floats for W4, 48 for W2, 20 for W8), or
    the warps' 8 x (columns + 4) partial tiles in the same memory."""
    bn, warps, slots = QMM_DEC_TILES[tile]
    slot = 2 * bits * (160 if bn == 128 else bn) + QGEMV_M_MAX * {4: 24, 2: 48, 8: 20}[bits] * 4
    return max(warps * slots * slot, warps * QGEMV_M_MAX * (bn + 4) * 4)


class QmmPlan(NamedTuple):
    """Launch plan of one qgemv / qmatmul / qmatmul_grouped call."""
    body: str            # "tc" / "simt" (tiles, tensor / CUDA cores), "gemv_tc" / "gemv" (M <= 8)
    tile: str            # tile class: "short", "wide", "dec16", "dec128", else the body's name
    arith: str           # "tf32x2", "bf16x3" (passes over x on the tensor cores) or "f32"
    bm: int
    bn: int
    bk: int
    split: int           # ways K is split: blocks of a cluster (tiles), warps (gemv_tc)
    stages: int          # cp.async ring depth (a warp's slots for gemv_tc; 0: loads through registers)
    threads: int
    grid: tuple          # (x, y, z) blocks
    blocks: int
    smem: int            # shared memory per block, bytes


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan_qgemv(K: int, N: int, G: int, bits: int, E: int = 1) -> QmmPlan:
    """Plan the decode matmul x (E, M <= 8, K) @ (codes, scales) -> (E, M,
    N) from K, N, G, bits and E alone: not from M, so a row's result does
    not depend on how many rows share the call. The tensor-core body
    ("gemv_tc") unless the scale groups are not a whole number of its 16-k
    units, which take the CUDA-core decode body ("gemv": a block per 64
    columns and expert, each code scaled as it is decoded). The tile is
    the widest whose grid fills the card (one block per 128 columns and
    expert), else the narrowest (16 columns a block)."""
    _check(min(K, N, G, E) >= 1 and bits in (2, 4, 8) and K % G == 0,
           "qgemv", f"no plan for K={K} N={N} G={G} bits={bits} E={E}")
    m = QGEMV_M_MAX
    if G > 1 and (K // G) % QMM_DEC_UNIT:
        per = 8 // bits
        stage = (128 // per) * QMM_GEMV_COLS + 128 * m * 4
        smem = max(4 * stage, 16 * m * QMM_GEMV_COLS * 4)
        _check_smem(smem, "qgemv")
        grid = (_ceil(N, QMM_GEMV_COLS), E, 1)
        return QmmPlan("gemv", "gemv", "f32", m, QMM_GEMV_COLS, 128, 1, 4,
                       QMM_GEMV_THREADS, grid, grid[0] * grid[1], smem)
    tile = "dec128" if _ceil(N, QMM_DEC_TILES["dec128"][0]) * E >= SM_COUNT else "dec16"
    bn, warps, slots = QMM_DEC_TILES[tile]
    smem = qmm_dec_smem(bits, tile)
    _check_smem(smem, "qgemv")
    grid = (_ceil(N, bn), E, 1)
    return QmmPlan("gemv_tc", tile, "bf16x3", m, bn, QMM_DEC_UNIT, warps, slots, 32 * warps,
                   grid, grid[0] * grid[1], smem)


@functools.lru_cache(maxsize=4096)
def plan_qmatmul(M: int, K: int, N: int, G: int, bits: int, E: int = 1,
                 grouped: bool = False) -> QmmPlan:
    """Plan x (E, M, K) @ (codes, scales) -> (E, M, N) from the shape
    alone. ``grouped`` (qmatmul_grouped): M <= 8 takes the decode plan
    (:func:`plan_qgemv`, which does not depend on M). Otherwise the tensor-core body, unless the scale groups are not a
    whole number of its k-unit (:func:`qmm_tc_unit`), which takes the
    CUDA-core tile. The tensor-core tile is the short one up to
    ``QMM_SHORT_M`` rows, the wide one above (where the groups are a whole
    number of its 16-k steps; else the short one); K is split over a cluster of
    2, 4 or 8 blocks until the grid holds the tile's target of blocks, as
    long as each block keeps at least one ring stage. The wide tile then
    splits further while blocks keep ``QMM_WIDE_MIN_STAGES`` stages and fit
    in one wave of resident blocks (from its shared memory), and a grid of
    more than a wave takes the split whose last wave is fullest."""
    _check(min(M, K, N, G, E) >= 1 and bits in (2, 4, 8) and K % G == 0,
           "qmatmul", f"no plan for M={M} K={K} N={N} G={G} bits={bits} E={E}")
    if grouped and M <= QGEMV_M_MAX:
        return plan_qgemv(K, N, G, bits, E)
    if G > 1 and (K // G) % qmm_tc_unit(bits):
        bm, bn, bk = QMM_SIMT_TILE
        split = 1 if grouped else 2
        grid = (_ceil(N, bn), _ceil(M, bm), E * split)
        smem = 2 * bk * 64 * 4 + (0 if grouped else bm * bn * 4)
        _check_smem(smem, "qmatmul")
        return QmmPlan("simt", "simt", "f32", bm, bn, bk, split, 0, QMM_SIMT_THREADS, grid,
                       grid[0] * grid[1] * grid[2], smem)
    wide_groups = G == 1 or (K // G) % QMM_WIDE_UNIT == 0
    tile = "wide" if M > QMM_SHORT_M and wide_groups else "short"
    bm, bn, threads, stages = QMM_TC_TILES[tile]
    base = _ceil(N, bn) * _ceil(M, bm) * E
    k_stages = _ceil(K, QMM_TC_BK)
    smem = qmm_tc_smem(bits, tile)
    _check_smem(smem, "qmatmul")

    def fits(sp: int) -> bool:  # a legal split: each block keeps a stage
        return sp <= QMM_MAX_SPLIT and sp <= k_stages and E * sp <= 65535

    split = 1
    while base * split < QMM_TARGET_BLOCKS[tile] and fits(2 * split):
        split *= 2
    if tile == "wide":
        wave = SM_COUNT * (SMEM_PER_BLOCK // (smem + 1024))  # resident blocks
        while (fits(2 * split) and base * 2 * split <= wave
               and k_stages >= 2 * split * QMM_WIDE_MIN_STAGES):
            split *= 2
        if base > wave and fits(2) and k_stages >= 2 * QMM_WIDE_MIN_STAGES:
            fill = [(-(-base * sp // wave) * wave / (base * sp), sp) for sp in (1, 2)]
            split = min(fill)[1]
    grid = (_ceil(N, bn), _ceil(M, bm), E * split)
    return QmmPlan("tc", tile, QMM_TC_ARITH[tile], bm, bn, QMM_TC_BK, split, stages,
                   threads, grid, base * split, smem)


def describe_kv_decode(q_shape, k8_shape, v8_shape=None, kscale_shape=None,
                       vscale_shape=None, kpos_shape=None, cur_shape=None) -> dict:
    """Validate a ``kv_decode`` (int8-KV decode attention) launch: q (B, H,
    hd) over int8 caches (B, S, K, hd) with scales (B, S, K), kpos (B, S)
    and cur (B,); the shapes given beyond q and k8 are checked against
    them. Any S works (the kernel masks the ragged tail). Conditions are
    tested before any message is formatted: this runs on every launch."""
    name = "kv_decode"
    if len(q_shape) != 3 or len(k8_shape) != 4:
        raise KernelSpecError(f"{name}: q {tuple(q_shape)} must be (B, H, hd) and "
                              f"the cache {tuple(k8_shape)} (B, S, K, hd)")
    B, H, hd = q_shape
    S, K = k8_shape[1], k8_shape[2]
    if not (K > 0 and H % K == 0):
        raise KernelSpecError(f"{name}: query heads H={H} not divisible into kv heads "
                              f"K={K} (q {tuple(q_shape)}, cache {tuple(k8_shape)})")
    G = H // K
    if tuple(k8_shape) != (B, S, K, hd):
        raise KernelSpecError(f"{name}: cache {tuple(k8_shape)} does not match q "
                              f"{tuple(q_shape)}")
    if not (B >= 1 and S >= 1):
        raise KernelSpecError(f"{name}: empty launch: q {tuple(q_shape)}, cache "
                              f"{tuple(k8_shape)}")
    if not (hd % 8 == 0 and 16 <= hd <= KV_HD_MAX):
        raise KernelSpecError(f"{name}: head dim hd={hd} must be a multiple of 8 in "
                              f"16..{KV_HD_MAX}: the kernel reads a row of int8 codes in "
                              f"8- or 16-byte vectors")
    if G > KV_G_MAX:
        raise KernelSpecError(f"{name}: G = H/K = {G} query rows per kv head; the kernel "
                              f"takes at most {KV_G_MAX} (q {tuple(q_shape)}, cache "
                              f"{tuple(k8_shape)})")
    for what, got, want in (("v8", v8_shape, (B, S, K, hd)),
                            ("kscale", kscale_shape, (B, S, K)),
                            ("vscale", vscale_shape, (B, S, K)),
                            ("kpos", kpos_shape, (B, S)), ("cur", cur_shape, (B,))):
        if got is not None and tuple(got) != want:
            raise KernelSpecError(f"{name}: {what} {tuple(got)} should be {want}")
    return {"B": B, "H": H, "K": K, "G": G, "S": S, "hd": hd,
            "body": kv_decode_body(hd)}


def kv_decode_body(hd: int) -> str:
    """``kv_decode``'s body for head dim ``hd`` (a multiple of 8): 16-byte
    loads of codes ("v16") when hd % 16 == 0, else 8-byte loads ("v8")."""
    return "v16" if hd % 16 == 0 else "v8"


def describe_kv_decode_paged(q_shape, kp_shape, vp_shape, ks_shape, vs_shape,
                             bt_shape, cur_shape, page_size: int) -> dict:
    """Validate a paged ``kv_decode`` launch: q (B, H, hd) over the pool's
    codes (num_pages, page_size, K, hd) and scales (num_pages, page_size,
    K) through block tables (B, max_pages), cur (B,). The dense view it
    reads has S = max_pages * page_size slots; :func:`describe_kv_decode`'s
    contract holds for it."""
    name = "kv_decode_paged"
    if len(kp_shape) != 4 or len(bt_shape) != 2:
        raise KernelSpecError(f"{name}: pool {tuple(kp_shape)} must be (pages, "
                              f"page_size, K, hd) and block tables {tuple(bt_shape)} "
                              f"(B, max_pages)")
    P, ps, K, hd = kp_shape
    B, mp = bt_shape
    if not (ps == page_size and P >= 1 and mp >= 1):
        raise KernelSpecError(f"{name}: pool {tuple(kp_shape)} does not hold pages of "
                              f"{page_size} slots, or the block tables {tuple(bt_shape)} "
                              f"are empty")
    for what, got, want in (("v_pages", vp_shape, (P, ps, K, hd)),
                            ("k_scale", ks_shape, (P, ps, K)),
                            ("v_scale", vs_shape, (P, ps, K))):
        if tuple(got) != want:
            raise KernelSpecError(f"{name}: {what} {tuple(got)} should be {want}")
    if len(q_shape) != 3 or q_shape[0] != B:
        raise KernelSpecError(f"{name}: q {tuple(q_shape)} and block tables "
                              f"{tuple(bt_shape)} disagree on B")
    sp = describe_kv_decode(q_shape, (B, mp * ps, K, hd), cur_shape=cur_shape)
    sp.update(pages=P, page_size=ps, max_pages=mp)
    return sp


class KvPlan(NamedTuple):
    """Launch plan of one kv_decode call (either entry)."""
    body: str     # "v16" / "v8": the load unit of codes
    warps: int    # warps a block, each on a contiguous share of the block's tiles
    split: int    # blocks of a cluster, each on a contiguous share of whole tiles
    rows: int     # query rows a block keeps (of a kv head's G)
    chunks: int   # blocks over one kv head's G rows, ceil(G / rows)
    units: int    # float4 accumulators a lane keeps
    blocks: int


@functools.lru_cache(maxsize=4096)
def kv_smem(rows: int, hd: int, warps: int, page_size: int = 0) -> int:
    """Dynamic shared memory of one kv_decode block, as the kernel lays it
    out (``make_layout``): q rows (later the block's accumulator) and the
    block's m and l, then for each warp its p * vs (rows, KV_TILE), its m,
    l and corr, the paged entry's page numbers (2 * (KV_STAGES - 1) + 1 tiles
    of (KV_TILE - 1) // page_size + 2 entries) and its ring of stages: K
    rows padded by KV_KPAD, V rows, K and V scales (a 32-bit word a slot)
    and the dense entry's kpos; at least 32 float4 partials and the warp's
    accumulator."""
    a16 = lambda x: (x + 15) & ~15  # noqa: E731
    pad = KV_KPAD[kv_decode_body(hd)]
    stage = KV_TILE * (2 * hd + pad + (8 if page_size else 12))
    pages = (2 * (KV_STAGES - 1) + 1) * ((KV_TILE - 1) // page_size + 2) if page_size else 0
    ring = max(KV_STAGES * stage, 32 * 16 + rows * hd * 4)
    warp = rows * KV_TILE * 4 + 3 * KV_G_MAX * 4 + a16(pages * 4) + a16(ring)
    return a16(rows * hd * 4) + 2 * KV_G_MAX * 4 + warps * warp


def kv_plan(hd: int, G: int, warps: int, split: int, B: int = 1, K: int = 1) -> KvPlan:
    """The KvPlan of these choices: the rows a block keeps (all G up to
    KV_BLOCK_VALUES values of q) and the accumulators a lane needs."""
    rows = min(G, KV_BLOCK_VALUES // hd)
    chunks = _ceil(G, rows)
    units = next(u for u in KV_UNITS if 128 * u >= rows * hd)
    return KvPlan(kv_decode_body(hd), warps, split, rows, chunks, units, B * K * chunks * split)


@functools.lru_cache(maxsize=4096)
def plan_kv_decode(B: int, K: int, S: int, hd: int, G: int = 1) -> KvPlan:
    """Plan kv_decode over (B, S, K, hd) caches with G query rows a kv head
    from the shapes alone (never the page size or the data), so the dense
    and paged entries of one shape take the same plan and sum in the same
    order. 8 warps a block for at least KV_WIDE_TILES tiles where two such
    blocks fit an SM, else 4; S is split over a cluster of 2, 4 or 8 blocks
    until the grid holds KV_TARGET_BLOCKS, as long as each warp keeps
    KV_MIN_TILES tiles, so each block's share is at least one tile (no share
    is empty)."""
    _check(min(B, K, S, G) >= 1 and hd % 8 == 0 and 16 <= hd <= KV_HD_MAX, "kv_decode",
           f"no plan for B={B} K={K} S={S} hd={hd} G={G}")
    tiles = _ceil(S, KV_TILE)
    rows = kv_plan(hd, G, KV_WARPS[1], 1).rows
    wide = tiles >= KV_WIDE_TILES and 2 * kv_smem(rows, hd, KV_WARPS[1], 1) <= SMEM_PER_BLOCK
    warps = KV_WARPS[1] if wide else KV_WARPS[0]
    blocks = kv_plan(hd, G, warps, 1, B, K).blocks
    split = 1
    while (blocks * split < KV_TARGET_BLOCKS and 2 * split <= KV_SPLITS[-1]
           and tiles >= 2 * split * warps * KV_MIN_TILES):
        split *= 2
    plan = kv_plan(hd, G, warps, split, B, K)
    smem = kv_smem(plan.rows, hd, warps, 1)
    _check_smem(smem, "kv_decode")
    return plan


def describe_fakequant(w_shape, scale_shape) -> dict:
    """Validate a ``fakequant`` (AdaRound forward) launch: w (K, N) with a
    scale of (1, N) (one per output channel) or (K, N). Any K and N (the
    kernel masks the ragged tail)."""
    name = "fakequant"
    if len(w_shape) != 2 or len(scale_shape) != 2:
        raise KernelSpecError(f"{name}: weight {tuple(w_shape)} and scale "
                              f"{tuple(scale_shape)} must both be 2-D")
    K, N = w_shape
    _check(K >= 1 and N >= 1, name, f"empty weight {tuple(w_shape)}")
    _check(tuple(scale_shape) in ((1, N), (K, N)), name,
           f"scale {tuple(scale_shape)} must be (1, {N}) or ({K}, {N}) for "
           f"weight {tuple(w_shape)}")
    return {"K": K, "N": N, "per_row": scale_shape[0] == K and K > 1}
