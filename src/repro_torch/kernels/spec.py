"""Shape contracts of the packed matmul kernels, with typed errors.

The port of the JAX package's ``repro.kernels.spec`` shape and
divisibility checks. The TPU's VMEM budget and block divisibility do not
carry over: the CUDA kernels mask ragged M and N themselves. What stays
is the packing contract (K = packed rows x values per byte, scales span
N, each scale group a whole number of packed rows) and the decode
kernel's row limit.
"""
from __future__ import annotations

# The decode kernel keeps one f32 accumulator per batch row and column in
# registers; it takes at most this many rows.
QGEMV_M_MAX = 8


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
