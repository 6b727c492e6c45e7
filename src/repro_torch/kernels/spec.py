"""Shape contracts of the CUDA kernels, with typed errors.

The port of the JAX package's ``repro.kernels.spec`` shape and
divisibility checks. The TPU's VMEM budget and block divisibility do not
carry over: the CUDA kernels mask ragged M and N, and a ragged cache
length S, themselves. What stays is the packing contract (K = packed rows
x values per byte, scales span N, each scale group a whole number of
packed rows), the GQA grouping of ``kv_decode`` (H % K == 0), and the
limits the CUDA kernels really have (decode rows, head dim, group size).
"""
from __future__ import annotations

# The decode kernel keeps one f32 accumulator per batch row and column in
# registers; it takes at most this many rows.
QGEMV_M_MAX = 8

# kv_decode keeps the G = H/K query rows of one (batch, kv-head) and their
# f32 accumulators in one block: at most this many rows of at most
# KV_HD_MAX values, read in 16-byte vectors of int8 codes (hd % 16 == 0).
KV_G_MAX = 16
KV_HD_MAX = 256


class KernelSpecError(ValueError):
    """A kernel launch's shapes violate its contract (shapes named)."""


def _check(cond: bool, kernel: str, msg: str) -> None:
    if not cond:
        raise KernelSpecError(f"{kernel}: {msg}")


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


def describe_kv_decode(q_shape, k8_shape, v8_shape=None, kscale_shape=None,
                       vscale_shape=None, kpos_shape=None, cur_shape=None) -> dict:
    """Validate a ``kv_decode`` (int8-KV decode attention) launch: q (B, H,
    hd) over int8 caches (B, S, K, hd) with scales (B, S, K), kpos (B, S)
    and cur (B,); the shapes given beyond q and k8 are checked against
    them. Any S works (the kernel masks the ragged tail)."""
    name = "kv_decode"
    if len(q_shape) != 3 or len(k8_shape) != 4:
        raise KernelSpecError(f"{name}: q {tuple(q_shape)} must be (B, H, hd) and "
                              f"the cache {tuple(k8_shape)} (B, S, K, hd)")
    B, H, hd = q_shape
    S, K = k8_shape[1], k8_shape[2]
    _check(K > 0 and H % K == 0, name,
           f"query heads H={H} not divisible into kv heads K={K} "
           f"(q {tuple(q_shape)}, cache {tuple(k8_shape)})")
    G = H // K
    _check(tuple(k8_shape) == (B, S, K, hd), name,
           f"cache {tuple(k8_shape)} does not match q {tuple(q_shape)}")
    _check(B >= 1 and S >= 1, name, f"empty launch: q {tuple(q_shape)}, "
           f"cache {tuple(k8_shape)}")
    _check(hd % 16 == 0 and 16 <= hd <= KV_HD_MAX, name,
           f"head dim hd={hd} must be a multiple of 16 in 16..{KV_HD_MAX}")
    _check(G <= KV_G_MAX, name,
           f"G = H/K = {G} query rows per kv head; the kernel takes at most "
           f"{KV_G_MAX} (q {tuple(q_shape)}, cache {tuple(k8_shape)})")
    for what, got, want in (("v8", v8_shape, (B, S, K, hd)),
                            ("kscale", kscale_shape, (B, S, K)),
                            ("vscale", vscale_shape, (B, S, K)),
                            ("kpos", kpos_shape, (B, S)), ("cur", cur_shape, (B,))):
        _check(got is None or tuple(got) == want, name,
               f"{what} {tuple(got or ())} should be {want}")
    return {"B": B, "H": H, "K": K, "G": G, "S": S, "hd": hd}


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
