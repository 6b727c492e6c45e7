"""Public wrapper for the fused AdaRound forward.

``adaround_forward(..., backend=)`` runs ``'cuda'`` (the hand-written
kernel; raises on CPU tensors), ``'torch'`` (the plain version) or
``'auto'`` (the kernel for CUDA tensors, the plain version for CPU
tensors), as ``qmm`` does.
"""
from __future__ import annotations

import torch

from ..spec import KernelSpecError
from . import kernel
from .ref import fakequant_ref

BACKENDS = ("auto", "torch", "cuda")


def covers(w: torch.Tensor, cfg) -> bool:
    """Whether the fused forward takes this weight and config: 2-D,
    symmetric, per-channel (no grouping). :func:`adaround_forward` raises
    :class:`KernelSpecError` exactly when this is false."""
    return w.ndim == 2 and cfg.group_size is None and cfg.symmetric


def adaround_forward(w: torch.Tensor, v: torch.Tensor, st, cfg, *,
                     hard: bool = False, backend: str = "auto") -> torch.Tensor:
    """Kernel-backed equivalent of ``core.adaround.soft_quant`` /
    ``hard_quant`` for 2-D per-channel weights (symmetric, no grouping).
    Forward only: it carries no gradient.

    Args:
      w: FP weight of shape (K, N), f32.
      v: AdaRound rounding logits, same shape as ``w``.
      st: quantizer state; ``st.scale`` must reshape to (1, N) or (K, N).
      cfg: quantizer config supplying the clip range ``[qmin, qmax]``;
        must be symmetric with ``group_size=None``.
      hard: ``False`` — soft rounding with the rectified sigmoid of ``v``;
        ``True`` — hardened rounding ``(v >= 0)``.
      backend: ``'auto'``, ``'torch'`` or ``'cuda'``.

    Raises:
      KernelSpecError: for weight ranks or quantizer configs the fused
        kernel does not cover (grouped or asymmetric quantization) —
        callers use ``core.adaround`` for those.
    """
    if w.ndim != 2:
        raise KernelSpecError(
            f"adaround_forward: weights must be 2-D (K, N), got shape "
            f"{tuple(w.shape)}")
    if cfg.group_size is not None or not cfg.symmetric:
        raise KernelSpecError(
            f"adaround_forward: only symmetric per-channel quantization is "
            f"fused (group_size=None, symmetric=True); got unsupported "
            f"config group_size={cfg.group_size}, symmetric={cfg.symmetric}")
    if backend not in BACKENDS:
        raise ValueError(f"adaround_forward backend {backend!r} not in {BACKENDS}")
    scale = st.scale.reshape(-1, w.shape[1])
    if backend == "auto":
        backend = "cuda" if w.is_cuda else "torch"
    if backend == "torch":
        return fakequant_ref(w, v, scale, cfg.qmin, cfg.qmax, hard)
    return kernel.fakequant(w, v, scale, qmin=cfg.qmin, qmax=cfg.qmax, hard=hard)
