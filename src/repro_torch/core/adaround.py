"""AdaRound learned rounding (Nagel et al. 2020), as used by BRECQ.

The port of the JAX package's ``repro.core.adaround``. Weights are
floor-quantized and a per-weight logit ``v`` chooses floor vs ceil through
a rectified sigmoid. During reconstruction the soft rounding value
h(v) in [0, 1] carries gradients (plain PyTorch under autograd); after
calibration the rounding is hardened to {0, 1} (Eq. 16 of the paper).

``hard_quant`` on a CUDA tensor runs the hand-written K5 kernel
(``kernels/fakequant``) for every weight that kernel covers (symmetric,
per-channel: 2-D, or a stack of experts (E, K, N) whose scale is shared
across experts); the plain formula serves the rest and CPU tensors. Which
one runs is decided by the config, the scale's shape and the device alone.

Clips that carry gradients are ``minimum(maximum(x, lo), hi)``, as
``jnp.clip``: at a tie both sides get half the gradient, where
``torch.clamp`` would pass all of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .quantizer import QConfig, QState, _group_reshape

# rectified-sigmoid stretch constants from the AdaRound paper
ZETA = 1.1
GAMMA = -0.1

_CONSTS: dict = {}


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """A cached 0-dim f32 constant on ``like``'s device (no host copy per
    call inside the calibration loop)."""
    key = (float(value), like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(float(value), dtype=torch.float32,
                                        device=like.device)
    return t


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, _c(lo, x)), _c(hi, x))


def rect_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """h(v) = clip(sigmoid(v) * (zeta - gamma) + gamma, 0, 1)."""
    return _clip(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def init_v(w: torch.Tensor, st: QState, cfg: QConfig) -> torch.Tensor:
    """Initialise v so that soft-quantization reproduces round-to-nearest."""
    if cfg.group_size is not None:
        wg = _group_reshape(w, cfg)
        frac = (wg / st.scale - torch.floor(wg / st.scale)).reshape(w.shape)
    else:
        frac = w / st.scale - torch.floor(w / st.scale)
    # invert h(v) = frac  =>  sigmoid(v) = (frac - gamma)/(zeta - gamma)
    p = torch.clamp((frac - GAMMA) / _c(ZETA - GAMMA, frac), 1e-4, 1 - 1e-4)
    return torch.log(p / (1 - p)).to(torch.float32)


def soft_quant(w: torch.Tensor, v: torch.Tensor, st: QState,
               cfg: QConfig) -> torch.Tensor:
    """Differentiable AdaRound forward: s * clip(floor(w/s) + h(v), n, p)."""
    if cfg.group_size is not None:
        wg = _group_reshape(w, cfg)
        hg = rect_sigmoid(v).reshape(wg.shape)
        q = _clip(torch.floor(wg / st.scale) + hg + st.zero_point,
                  cfg.qmin, cfg.qmax)
        return ((q - st.zero_point) * st.scale).reshape(w.shape)
    q = _clip(torch.floor(w / st.scale) + rect_sigmoid(v) + st.zero_point,
              cfg.qmin, cfg.qmax)
    return (q - st.zero_point) * st.scale


def hard_quant(w: torch.Tensor, v: torch.Tensor, st: QState,
               cfg: QConfig) -> torch.Tensor:
    """Post-calibration forward: h(v) hardened to {0, 1}. Through K5 for
    CUDA tensors of a covered config; bit-identical to the formula below
    (zero point 0, ``q * s == (q - 0) * s``)."""
    from ..kernels.fakequant import ops as fq_ops

    if w.is_cuda and fq_ops.covers(w, cfg, st.scale):
        return fq_ops.adaround_forward(w, v, st, cfg, hard=True, backend="cuda")
    hard = (v >= 0).to(w.dtype)
    if cfg.group_size is not None:
        wg = _group_reshape(w, cfg)
        q = torch.clamp(torch.floor(wg / st.scale) + hard.reshape(wg.shape)
                        + st.zero_point, cfg.qmin, cfg.qmax)
        return ((q - st.zero_point) * st.scale).reshape(w.shape)
    q = torch.clamp(torch.floor(w / st.scale) + hard + st.zero_point,
                    cfg.qmin, cfg.qmax)
    return (q - st.zero_point) * st.scale


def hard_int_codes(w: torch.Tensor, v: torch.Tensor, st: QState,
                   cfg: QConfig) -> torch.Tensor:
    """Integer codes after hardening (deployment path, feeds pack_int)."""
    hard = (v >= 0).to(torch.float32)
    if cfg.group_size is not None:
        wg = _group_reshape(w, cfg)
        q = torch.clamp(torch.floor(wg / st.scale) + hard.reshape(wg.shape)
                        + st.zero_point, cfg.qmin, cfg.qmax)
        return q.reshape(w.shape).to(torch.int8)
    q = torch.clamp(torch.floor(w / st.scale) + hard + st.zero_point,
                    cfg.qmin, cfg.qmax)
    return q.to(torch.int8)


def round_reg(v: torch.Tensor, beta) -> torch.Tensor:
    """f_reg = sum_i (1 - |2 h(v_i) - 1|^beta)."""
    return torch.sum(1.0 - torch.abs(2.0 * rect_sigmoid(v) - 1.0) ** beta)


@dataclasses.dataclass(frozen=True)
class BetaSchedule:
    """Anneal beta high->low so h(v) converges to binary.

    ``warmup`` fraction of iterations applies no regularization at all
    (AdaRound default 0.2), then beta decays linearly beta_hi -> beta_lo.
    """

    beta_hi: float = 20.0
    beta_lo: float = 2.0
    warmup: float = 0.2

    def __call__(self, it, total: int) -> tuple[float, float]:
        """Returns (beta, reg_enabled) for iteration ``it`` (an int), in
        f32 arithmetic on the host, as the JAX schedule computes them on
        the device."""
        f = np.float32
        t = (f(it) / f(total) - f(self.warmup)) / f(1.0 - self.warmup)
        t = min(max(t, f(0.0)), f(1.0))
        beta = f(self.beta_hi) + f(self.beta_lo - self.beta_hi) * t
        enabled = f(f(it) >= f(self.warmup * total))
        return float(beta), float(enabled)
