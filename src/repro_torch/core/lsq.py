"""Learned-step-size (LSQ, Esser et al. 2020) activation quantization.

The port of the JAX package's ``repro.core.lsq``. BRECQ learns only the
step size ``s`` per tensor, with the gradient of Eq. (18):

    dL/ds = dL/dx_hat * ( -x/s + x_hat/s )      inside the range
    dL/ds = dL/dx_hat * qmin_or_qmax            outside (clipped)

Per the paper's appendix B.4.4 the LSQ gradient scale is NOT applied.
"""
from __future__ import annotations

import torch


def _range(bits: int, symmetric: bool) -> tuple[int, int]:
    if symmetric:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


def init_act_scale(x: torch.Tensor, bits: int, symmetric: bool = False) -> torch.Tensor:
    """Init from the first calibration batch: minmax over the tensor."""
    qmax = _range(bits, symmetric)[1]
    amax = torch.max(torch.abs(x)) if symmetric else torch.max(x)
    q = torch.tensor(float(qmax), dtype=amax.dtype, device=amax.device)
    return torch.clamp_min(amax / q, 1e-8).to(torch.float32)


class _LSQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, bits, symmetric):
        n, p = _range(bits, symmetric)
        ctx.save_for_backward(x, s)
        ctx.np = (n, p)
        return torch.clamp(torch.round(x / s), n, p) * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        n, p = ctx.np
        xs = x / s
        in_range = (xs >= n) & (xs <= p)
        # dL/dx: straight-through inside range
        gx = g * in_range
        # dL/ds per Eq. (18)
        rounded = torch.clamp(torch.round(xs), n, p)
        ds_elem = torch.where(in_range, rounded - xs, rounded)  # clipped -> n or p
        gs = torch.sum(g * ds_elem).to(s.dtype).reshape(s.shape)
        return gx, gs, None, None


def lsq_quant(x: torch.Tensor, s: torch.Tensor, bits: int,
              symmetric: bool = False) -> torch.Tensor:
    """Fake-quantize ``x`` with learnable step ``s`` (scalar per tensor)."""
    return _LSQ.apply(x, s, bits, symmetric)
