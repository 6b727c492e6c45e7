"""Plain PyTorch versions of the packed dequant-matmul kernels.

``qmatmul_ref`` is the literal prefill version (dequantize, then dot).
``qgemv_ref`` is the decode-shaped version in the JAX package's
scale-after-dot form: it contracts the integer codes first and applies
the per-group scales to the (G, M, N) partial sums. For stacked experts,
``qmm_grouped_ref`` loops ``qgemv_ref`` over E (one expert's (K, N)
resident at a time, the decode form) and ``qmm_grouped_dense_ref``
dequantizes (E, K, N) once for one batched product (the prefill form).
These run on CPU
tensors (the tests hold them against the JAX package) and serve as the
reference the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch

from ...core.quantizer import unpack_int


def dequant(w_packed: torch.Tensor, scales: torch.Tensor, bits: int,
            k: int) -> torch.Tensor:
    """(K/per, N) packed int8 + (G, N) scales -> (K, N) f32 weights."""
    codes = unpack_int(w_packed, bits, k).to(torch.float32)  # (K, N)
    g = k // scales.shape[0]
    codes = codes.reshape(scales.shape[0], g, -1) * scales[:, None, :]
    return codes.reshape(k, -1)


def qmatmul_ref(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor,
                bits: int) -> torch.Tensor:
    """x: (M, K); w_packed: (K*bits/8, N) int8; scales: (G, N)."""
    k = w_packed.shape[0] * (8 // bits)
    w = dequant(w_packed, scales, bits, k)
    return (x.to(torch.float32) @ w).to(x.dtype)


def qgemv_ref(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor,
              bits: int) -> torch.Tensor:
    """Decode-shaped version: ``sum_g s[g] * (x_g @ codes_g)``."""
    k = w_packed.shape[0] * (8 // bits)
    m = x.shape[0]
    g_rows = scales.shape[0]
    codes = unpack_int(w_packed, bits, k).to(torch.float32)  # (K, N)
    if g_rows == 1:  # per-channel: one plain dot, then an (M, N) scale
        out = (x.to(torch.float32) @ codes) * scales
    else:  # grouped: G batched (M, K/G) dots, scales on the partials
        cg = codes.reshape(g_rows, k // g_rows, -1)
        xg = x.to(torch.float32).reshape(m, g_rows, k // g_rows)
        partial = torch.einsum("mgk,gkn->gmn", xg, cg)
        out = torch.einsum("gmn,gn->mn", partial, scales.to(torch.float32))
    return out.to(x.dtype)


def qmm_grouped_ref(x: torch.Tensor, w_packed: torch.Tensor,
                    scales: torch.Tensor, bits: int) -> torch.Tensor:
    """Stacked-expert decode version, one expert resident at a time.

    x: (E, M, K); w_packed: (E, K*bits/8, N) int8; scales: (E, G, N).
    Per expert it is :func:`qgemv_ref`'s scale-after-dot form, so the
    unpacked transient never exceeds one (K, N).
    """
    return torch.stack([qgemv_ref(x[e], w_packed[e], scales[e], bits)
                        for e in range(x.shape[0])])


def qmm_grouped_dense_ref(x: torch.Tensor, w_packed: torch.Tensor,
                          scales: torch.Tensor, bits: int) -> torch.Tensor:
    """Stacked-expert prefill version: dequantize (E, K, N) once, then one
    batched product over E. Same contract as :func:`qmm_grouped_ref`."""
    k = w_packed.shape[-2] * (8 // bits)
    codes = unpack_int(w_packed, bits, k, axis=-2).to(torch.float32)
    g_rows = scales.shape[-2]
    cg = codes.reshape(*codes.shape[:-2], g_rows, k // g_rows, codes.shape[-1])
    w = (cg * scales[..., :, None, :]).reshape(codes.shape)
    return torch.einsum("emk,ekn->emn", x.to(torch.float32), w).to(x.dtype)
