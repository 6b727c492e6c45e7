"""Plain PyTorch version of the fused AdaRound forward (the kernel's oracle)."""
from __future__ import annotations

import torch

ZETA, GAMMA = 1.1, -0.1


def fakequant_ref(w: torch.Tensor, v: torch.Tensor, scale: torch.Tensor,
                  qmin: int, qmax: int, hard: bool) -> torch.Tensor:
    """w, v: (K, N); scale: (1|K, N) broadcastable. AdaRound forward:
    ``clip(floor(w / s) + h, qmin, qmax) * s`` with ``h = (v >= 0)`` when
    hard, else the rectified sigmoid of ``v``."""
    if hard:
        h = (v >= 0).to(torch.float32)
    else:
        h = torch.clamp(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)
    q = torch.clamp(torch.floor(w / scale) + h, qmin, qmax)
    return (q * scale).to(w.dtype)
