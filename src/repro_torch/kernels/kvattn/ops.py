"""Public wrappers for int8-KV decode attention + cache quantization.

``attend_int8(..., backend=)`` over a dense cache and
``attend_int8_paged(..., backend=)`` over the serve engine's page pool run
``'cuda'`` (the hand-written kernel; raises on CPU tensors), ``'torch'``
(the plain version) or ``'auto'`` (the kernel for CUDA tensors, the plain
version for CPU tensors), as ``qmm`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernel
from .ref import kv_decode_ref, paged_view

BACKENDS = ("auto", "torch", "cuda")

# The JAX package quantizes inside jitted programs, where XLA rewrites
# ``amax / 127`` as ``amax * f32(1/127)``; multiplying by the same f32
# reciprocal gives the same scales bit for bit.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Quantize KV caches to int8 with per-(token, head) scales.

    k, v: float caches of shape (B, S, K_heads, head_dim). Returns ``(k8,
    v8, kscale, vscale)``: int8 codes with the input shapes (round half to
    even) and f32 scales ``max(absmax * f32(1/127), 1e-8)`` of shape (B, S,
    K_heads).
    """
    def q(x):
        x32 = x.to(torch.float32)
        amax = x32.abs().amax(dim=-1)
        scale = torch.clamp_min(amax * _INV_127, 1e-8)
        codes = torch.clamp(torch.round(x32 / scale[..., None]), -128, 127)
        return codes.to(torch.int8), scale

    k8, ks = q(k)
    v8, vs = q(v)
    return k8, v8, ks, vs


def attend_int8(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                kscale: torch.Tensor, vscale: torch.Tensor, kpos: torch.Tensor,
                cur_pos: torch.Tensor, *, window=None,
                backend: str = "auto") -> torch.Tensor:
    """Single-step decode attention over an int8-quantized KV cache.

    q (B, H, hd); k8/v8 (B, S, K_heads, hd) int8 with ``H % K_heads ==
    0``; kscale/vscale (B, S, K_heads) f32 from :func:`quantize_kv`; kpos
    (B, S) int32, negative for an empty slot; cur_pos (B,) int32, slots
    with ``kpos > cur_pos`` are masked; ``window`` masks positions older
    than ``cur_pos - window``. Returns (B, H, hd) in ``q``'s dtype.
    """
    if backend not in BACKENDS:
        raise ValueError(f"attend_int8 backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if q.is_cuda else "torch"
    if backend == "torch":
        return kv_decode_ref(q, k8, v8, kscale, vscale, kpos, cur_pos, window)
    return kernel.kv_decode(q, k8, v8, kscale, vscale, kpos, cur_pos,
                            window=window)


def attend_int8_paged(q: torch.Tensor, cache: dict, block_tables: torch.Tensor,
                      cur_pos: torch.Tensor, page_size: int, *, window=None,
                      backend: str = "auto") -> torch.Tensor:
    """Single-step decode attention over one layer's int8 page pool.

    q (B, H, hd); ``cache`` holds ``k_pages``/``v_pages`` (num_pages,
    page_size, K_heads, hd) int8 and ``k_scale``/``v_scale`` (num_pages,
    page_size, K_heads) float16 (``models.common.init_paged_kv``);
    block_tables (B, max_pages) int32, -1 = unallocated; cur_pos (B,) int32.
    ``'cuda'`` reads the pool through the block tables in the kernel
    (``kernel.kv_decode_paged``); ``'torch'`` gathers the dense view
    (``ref.paged_view``: codes, scales widened to f32, kpos) and
    runs :func:`kv_decode_ref` on it. Returns (B, H, hd) in ``q``'s dtype.
    """
    if backend not in BACKENDS:
        raise ValueError(f"attend_int8_paged backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if q.is_cuda else "torch"
    if backend == "torch":
        gather, kpos = paged_view(cache, block_tables, page_size)
        return kv_decode_ref(q, gather(cache["k_pages"]), gather(cache["v_pages"]),
                             gather(cache["k_scale"]).to(torch.float32),
                             gather(cache["v_scale"]).to(torch.float32), kpos, cur_pos,
                             window)
    return kernel.kv_decode_paged(q, cache["k_pages"], cache["v_pages"], cache["k_scale"],
                                  cache["v_scale"], block_tables, cur_pos,
                                  page_size=page_size, window=window)
