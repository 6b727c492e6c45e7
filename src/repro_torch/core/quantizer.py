"""Uniform quantizers: the parameter-space primitives BRECQ builds on.

The port of the JAX package's ``repro.core.quantizer``. A quantizer is a
static :class:`QConfig` plus a :class:`QState` of tensors (scales and zero
points) that lives on the weight's device.

  * uniform symmetric grid ``Q_b = s * {-2^{b-1}, ..., 2^{b-1}-1}``;
  * scale init by min-max or the MSE-optimal grid search over the same 80
    f32 clip ratios as the JAX package (``MSE_RATIOS``);
  * sub-byte packing of integer codes (the deployment format; layout
    below).

Divisions by a bit-width constant go through a tensor on the operand's
device: on CUDA, ``tensor / python_float`` multiplies by the reciprocal,
which is not the quotient the JAX package computes eagerly.
``torch.round`` and ``jnp.round`` both round half to even.

Packing layout (offset-binary, shared bit for bit with
``repro.core.quantizer``): codes are packed ``per = 8 // bits`` to a byte
along ``axis``; field ``i`` of packed row ``r`` holds row ``r * per + i``
at shift ``bits * i`` and stores ``code + 2**(bits - 1)``, so unpacking is
mask and shift only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# jnp.linspace(0.35, 1.0, 80) as float32, copied value for value: the MSE
# search must try exactly the JAX package's candidates.
MSE_RATIOS = (
    0.3499999940395355, 0.35822784900665283, 0.36645567417144775,
    0.37468352913856506, 0.38291141390800476, 0.3911392390727997,
    0.399367094039917, 0.4075949490070343, 0.4158227741718292,
    0.42405062913894653, 0.43227848410606384, 0.44050630927085876,
    0.4487341642379761, 0.4569620192050934, 0.4651898443698883,
    0.4734176993370056, 0.4816455841064453, 0.48987340927124023,
    0.49810126423835754, 0.5063291192054749, 0.5145570039749146,
    0.5227848291397095, 0.5310126543045044, 0.5392405390739441,
    0.547468364238739, 0.5556961894035339, 0.5639240741729736,
    0.5721518993377686, 0.5803797245025635, 0.5886076092720032,
    0.5968354344367981, 0.6050633192062378, 0.6132911443710327,
    0.6215190291404724, 0.6297468543052673, 0.6379746794700623,
    0.646202564239502, 0.6544303894042969, 0.6626582145690918,
    0.6708860993385315, 0.6791139245033264, 0.6873417496681213,
    0.695569634437561, 0.703797459602356, 0.7120253443717957,
    0.7202531695365906, 0.7284809947013855, 0.7367088794708252,
    0.7449367046356201, 0.753164529800415, 0.7613924145698547,
    0.7696202397346497, 0.7778481245040894, 0.7860759496688843,
    0.7943037748336792, 0.8025316596031189, 0.8107595443725586,
    0.8189873695373535, 0.8272151947021484, 0.8354430198669434,
    0.8436709046363831, 0.851898729801178, 0.8601266145706177,
    0.8683544397354126, 0.8765822649002075, 0.8848101496696472,
    0.8930379748344421, 0.9012658596038818, 0.9094936847686768,
    0.9177215099334717, 0.9259493947029114, 0.9341772198677063,
    0.9424050450325012, 0.9506329298019409, 0.9588607549667358,
    0.9670886397361755, 0.9753164649009705, 0.9835442900657654,
    0.9917721748352051, 1.0)


@dataclasses.dataclass(frozen=True)
class QConfig:
    """Static description of a uniform quantizer.

    Attributes:
      bits: bit-width b; grid has 2^b levels.
      symmetric: symmetric signed grid (weights) vs asymmetric unsigned.
      channel_axis: axis that keeps its own scale (per-channel); ``None``
        means one scale per tensor.
      group_size: optional sub-channel grouping along the reduction axis
        (axis -2 of an (..., in, out) weight); ``None`` disables grouping.
      scale_method: 'minmax' | 'mse'.
    """

    bits: int = 8
    symmetric: bool = True
    channel_axis: Optional[int] = None
    group_size: Optional[int] = None
    scale_method: str = "minmax"

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2**self.bits - 1


@dataclasses.dataclass
class QState:
    """Quantizer state: f32 ``scale`` broadcastable against the tensor and
    its ``zero_point`` (0 for symmetric)."""

    scale: torch.Tensor
    zero_point: torch.Tensor

    def to(self, device) -> "QState":
        return QState(self.scale.to(device), self.zero_point.to(device))


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-dim f32 tensor on ``x``'s device (exact division, see module doc)."""
    return torch.tensor(float(value), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# scale initialisation
# ---------------------------------------------------------------------------


def _reduce_axes(x: torch.Tensor, cfg: QConfig) -> tuple[int, ...]:
    if cfg.channel_axis is None:
        return tuple(range(x.ndim))
    ax = cfg.channel_axis % x.ndim
    return tuple(i for i in range(x.ndim) if i != ax)


def _group_reshape(x: torch.Tensor, cfg: QConfig) -> torch.Tensor:
    """Reshape (..., in, out) -> (..., groups, group_size, out)."""
    g = cfg.group_size
    if x.ndim < 2 or g is None or x.shape[-2] % g:
        raise ValueError(f"group quantization of shape {tuple(x.shape)} with "
                         f"group_size={g}: needs (..., in, out) with in % g == 0")
    return x.reshape(*x.shape[:-2], x.shape[-2] // g, g, x.shape[-1])


def _amax_state(x: torch.Tensor, axes, cfg: QConfig) -> QState:
    if cfg.symmetric:
        amax = torch.amax(x.abs(), dim=axes, keepdim=True)
        scale = torch.clamp_min(amax / _const(x, cfg.qmax), 1e-8)
        zp = torch.zeros_like(scale)
    else:
        lo = torch.amin(x, dim=axes, keepdim=True)
        hi = torch.amax(x, dim=axes, keepdim=True)
        scale = torch.clamp_min((hi - lo) / _const(x, cfg.qmax - cfg.qmin), 1e-8)
        zp = torch.round(-lo / scale)
    return QState(scale.to(torch.float32), zp.to(torch.float32))


def _minmax_scale(x: torch.Tensor, cfg: QConfig) -> QState:
    return _amax_state(x, _reduce_axes(x, cfg), cfg)


def _best_ratio(x: torch.Tensor, st: QState, cfg: QConfig, axes) -> QState:
    """Scale times the candidate ratio with the least squared error (the
    first such on ties, as ``jnp.argmin``)."""
    ratios = torch.tensor(MSE_RATIOS, dtype=torch.float32, device=x.device)
    errs = []
    for r in ratios:
        q = _qdq_raw(x, QState(st.scale * r, st.zero_point), cfg)
        errs.append(torch.sum((q - x) ** 2, dim=axes, keepdim=True))
    best = torch.argmin(torch.stack(errs), dim=0)
    return QState(st.scale * ratios[best], st.zero_point)


def _mse_scale(x: torch.Tensor, cfg: QConfig) -> QState:
    """Grid-search the clip ratio minimising ||x - q(x)||^2 (paper's OMSE)."""
    return _best_ratio(x, _minmax_scale(x, cfg), cfg, _reduce_axes(x, cfg))


def init_qstate(x: torch.Tensor, cfg: QConfig) -> QState:
    """Initialise scales for tensor ``x`` under ``cfg``."""
    if cfg.group_size is not None:
        xg = _group_reshape(x, cfg)
        # one scale per (group, out-channel): reduce over the group axis only
        st = _amax_state(xg, (-2,), cfg)
        if cfg.scale_method == "mse":
            st = _best_ratio(xg, st, cfg, (-2,))
        return st
    if cfg.scale_method == "mse":
        return _mse_scale(x, cfg)
    return _minmax_scale(x, cfg)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------


def _qdq_raw(x: torch.Tensor, st: QState, cfg: QConfig) -> torch.Tensor:
    q = torch.clamp(torch.round(x / st.scale) + st.zero_point, cfg.qmin, cfg.qmax)
    return (q - st.zero_point) * st.scale


def quantize_int(x: torch.Tensor, st: QState, cfg: QConfig) -> torch.Tensor:
    """Return the integer codes (int8 container regardless of bits<=8)."""
    xg = _group_reshape(x, cfg) if cfg.group_size is not None else x
    q = torch.clamp(torch.round(xg / st.scale) + st.zero_point, cfg.qmin, cfg.qmax)
    return q.reshape(x.shape).to(torch.int8)


def dequantize_int(q: torch.Tensor, st: QState, cfg: QConfig) -> torch.Tensor:
    if cfg.group_size is not None:
        qg = _group_reshape(q.to(torch.float32), cfg)
        return ((qg - st.zero_point) * st.scale).reshape(q.shape)
    return (q.to(torch.float32) - st.zero_point) * st.scale


def quantize_dequant(x: torch.Tensor, st: QState, cfg: QConfig) -> torch.Tensor:
    """Fake-quantize (round-to-nearest). Used by RTN and scale search."""
    if cfg.group_size is not None:
        return _qdq_raw(_group_reshape(x, cfg), st, cfg).reshape(x.shape)
    return _qdq_raw(x, st, cfg)


class _FakeQuantSTE(torch.autograd.Function):
    """Round-to-nearest forward; straight-through gradient inside the clip
    range, zero outside; no gradient to the state (JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, scale, zero_point, cfg):
        st = QState(scale, zero_point)
        ctx.save_for_backward(x, scale, zero_point)
        ctx.cfg = cfg
        return quantize_dequant(x, st, cfg)

    @staticmethod
    def backward(ctx, g):
        x, scale, zp = ctx.saved_tensors
        cfg = ctx.cfg
        lo = (cfg.qmin - zp) * scale
        hi = (cfg.qmax - zp) * scale
        xg = _group_reshape(x, cfg) if cfg.group_size is not None else x
        mask = ((xg >= lo) & (xg <= hi)).reshape(x.shape)
        return g * mask, torch.zeros_like(scale), torch.zeros_like(zp), None


def fake_quant_ste(x: torch.Tensor, st: QState, cfg: QConfig) -> torch.Tensor:
    return _FakeQuantSTE.apply(x, st.scale, st.zero_point, cfg)


# ---------------------------------------------------------------------------
# packing (deployment format consumed by kernels/qmatmul)
# ---------------------------------------------------------------------------


def pack_int(q: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack integer codes along ``axis`` into an int8 container.

    int8 -> identity; int4 -> 2 values/byte; int2 -> 4 values/byte.
    """
    if bits == 8:
        return q.to(torch.int8)
    per = 8 // bits
    axis = axis % q.ndim
    if q.shape[axis] % per:
        raise ValueError(f"axis {axis} of codes {tuple(q.shape)} is not a "
                         f"multiple of {per} ({bits}-bit packing)")
    off = (q.to(torch.int32) + 2 ** (bits - 1)).to(torch.uint8)
    off = off.reshape(*q.shape[:axis], q.shape[axis] // per, per,
                      *q.shape[axis + 1:])
    out = torch.zeros_like(off.select(axis + 1, 0))
    for i in range(per):
        out |= off.select(axis + 1, i) << (bits * i)
    return out.view(torch.int8)


def unpack_int(p: torch.Tensor, bits: int, rows: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int`: int8 codes with ``rows`` along ``axis``."""
    if bits == 8:
        return p.to(torch.int8)
    per = 8 // bits
    axis = axis % p.ndim
    mask = (1 << bits) - 1
    u = p.contiguous().view(torch.uint8)
    parts = [((u >> (bits * i)) & mask).to(torch.int32) - 2 ** (bits - 1)
             for i in range(per)]
    out = torch.stack(parts, dim=axis + 1)
    out = out.reshape(*p.shape[:axis], rows, *p.shape[axis + 1:])
    return out.to(torch.int8)
