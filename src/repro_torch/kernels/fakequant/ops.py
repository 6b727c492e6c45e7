"""Public wrapper for the fused AdaRound forward.

``adaround_forward(..., backend=)`` runs ``'cuda'`` (the hand-written
kernel; raises on CPU tensors), ``'torch'`` (the plain version) or
``'auto'`` (the kernel for CUDA tensors, the plain version for CPU
tensors), as ``qmm`` does.
"""
from __future__ import annotations

import torch

from .. import record
from ..spec import KernelSpecError
from . import kernel
from .ref import fakequant_ref

BACKENDS = ("auto", "torch", "cuda")


def covers(w: torch.Tensor, cfg, scale: torch.Tensor) -> bool:
    """Whether the fused forward takes this weight, config and scale:
    symmetric, per-channel (no grouping), ``w`` of rank >= 2, and for rank
    > 2 (stacked experts, (E, K, N)) a scale shared across the leading dims
    (one per output channel). :func:`adaround_forward` raises
    :class:`KernelSpecError` exactly when this is false."""
    if w.ndim < 2 or cfg.group_size is not None or not cfg.symmetric:
        return False
    return w.ndim == 2 or scale.numel() == w.shape[-1]


def adaround_forward(w: torch.Tensor, v: torch.Tensor, st, cfg, *,
                     hard: bool = False, backend: str = "auto") -> torch.Tensor:
    """Kernel-backed equivalent of ``core.adaround.soft_quant`` /
    ``hard_quant`` for per-channel weights (symmetric, no grouping).
    Forward only: it carries no gradient. A weight of rank > 2 (a stack of
    experts, (E, K, N), whose scale is shared across experts) runs as its
    contiguous (E*K, N) view.

    Args:
      w: FP weight of shape (K, N) or (..., K, N), f32.
      v: AdaRound rounding logits, same shape as ``w``.
      st: quantizer state; ``st.scale`` must reshape to (1, N), or to
        (K, N) for a 2-D weight.
      cfg: quantizer config supplying the clip range ``[qmin, qmax]``;
        must be symmetric with ``group_size=None``.
      hard: ``False`` — soft rounding with the rectified sigmoid of ``v``;
        ``True`` — hardened rounding ``(v >= 0)``.
      backend: ``'auto'``, ``'torch'`` or ``'cuda'``.

    Raises:
      KernelSpecError: for weight ranks, scales or quantizer configs the
        fused kernel does not cover (1-D weights, per-expert scales,
        grouped or asymmetric quantization) — callers use
        ``core.adaround`` for those.
    """
    if w.ndim < 2:
        raise KernelSpecError(
            f"adaround_forward: weights must be (K, N) or (..., K, N), got "
            f"shape {tuple(w.shape)}")
    if cfg.group_size is not None or not cfg.symmetric:
        raise KernelSpecError(
            f"adaround_forward: only symmetric per-channel quantization is "
            f"fused (group_size=None, symmetric=True); got unsupported "
            f"config group_size={cfg.group_size}, symmetric={cfg.symmetric}")
    if not covers(w, cfg, st.scale):
        raise KernelSpecError(
            f"adaround_forward: a weight of shape {tuple(w.shape)} needs a "
            f"scale shared across its leading dims ({w.shape[-1]} values), "
            f"got {tuple(st.scale.shape)}")
    if backend not in BACKENDS:
        raise ValueError(f"adaround_forward backend {backend!r} not in {BACKENDS}")
    scale = st.scale.reshape(-1, w.shape[-1])
    if backend == "auto":
        backend = "cuda" if w.is_cuda else "torch"
    with record.call(record.fq_work, w.numel() // w.shape[-1], w.shape[-1],
                     scale.shape[0]):
        if backend == "torch":
            return fakequant_ref(w, v, scale, cfg.qmin, cfg.qmax, hard)
        return kernel.fakequant(w, v, scale, qmin=cfg.qmin, qmax=cfg.qmax, hard=hard)
