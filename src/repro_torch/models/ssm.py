"""Selective SSM (Mamba-style) head of the Hymba hybrid blocks.

The port of the JAX package's ``repro.models.ssm``. The full-sequence
forward evaluates the first-order linear recurrence h_t = a_t * h_{t-1} +
b_t with ``common.associative_scan`` (JAX's odd/even recursion, so the
operands meet in JAX's order); decode carries an explicit (B, d_inner,
d_state) state plus a short conv buffer. The projections are dense nodes
(quantized, packed for serving); ``A_log``, ``D``, ``dt_bias`` and
``conv_w`` stay f32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import common as cm
from .common import Ctx


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4


def init(gen: torch.Generator, spec: SSMSpec):
    d, di, n = spec.d_model, spec.d_inner, spec.d_state
    dev = gen.device
    return {
        "in_proj": cm.dense_init(gen, d, 2 * di),  # -> (x, z-gate)
        "wB": cm.dense_init(gen, di, n),
        "wC": cm.dense_init(gen, di, n),
        "w_dt": cm.dense_init(gen, di, di),
        "out_proj": cm.dense_init(gen, di, d),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                           ).expand(di, n).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32, device=dev),  # softplus^-1(0.01)
        "conv_w": torch.randn((spec.d_conv, di), generator=gen, dtype=torch.float32,
                              device=dev) * 0.1,
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, S, di), w: (K, di)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _ssm_coeffs(ctx: Ctx, p, spec: SSMSpec, xi: torch.Tensor):
    """Shared between scan and step. xi: (..., di) post-conv activations."""
    dt = cm.softplus(cm.dense(ctx, p, "w_dt", xi) + p["dt_bias"])  # (..., di)
    A = -torch.exp(p["A_log"])  # (di, n)
    Bc = cm.dense(ctx, p, "wB", xi)  # (..., n)
    Cc = cm.dense(ctx, p, "wC", xi)  # (..., n)
    a = torch.exp(dt[..., None] * A)  # (..., di, n)
    b = dt[..., None] * Bc[..., None, :] * xi[..., None]  # (..., di, n)
    return a, b, Cc


def _combine(left, right):
    """h = a * h_prev + b, composed: (a_l, b_l) then (a_r, b_r)."""
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def _scan(ctx: Ctx, p, spec: SSMSpec, x: torch.Tensor):
    """Full-sequence forward from the zero state. Returns (out (B, S, d),
    the pre-conv x branch (B, S, di), every step's state (B, S, di, n))."""
    xz = cm.dense(ctx, p, "in_proj", x)
    xi, z = xz.chunk(2, dim=-1)
    xi_c = F.silu(_conv_causal(xi, p["conv_w"]))
    a, b, Cc = _ssm_coeffs(ctx, p, spec, xi_c)  # (B, S, di, n)
    _, h = cm.associative_scan(_combine, (a.to(torch.float32), b.to(torch.float32)), 1)
    y = torch.einsum("bsdn,bsn->bsd", h, Cc.to(torch.float32)).to(x.dtype)
    y = (y + p["D"] * xi_c) * F.silu(z)
    return cm.dense(ctx, p, "out_proj", y), xi, h


def apply(ctx: Ctx, p, spec: SSMSpec, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x: (B, S, d) -> (B, S, d)."""
    return _scan(ctx, p, spec, x)[0]


def prefill(ctx: Ctx, p, spec: SSMSpec, x: torch.Tensor):
    """The forward over a prompt, and the recurrent state after it: the
    last step's ``h`` and the last ``d_conv - 1`` pre-conv inputs (JAX's
    ``_ssm_prefill``). Prompts shorter than that raise."""
    K = spec.d_conv - 1
    if x.shape[1] < K:
        raise ValueError(f"SSM prefill of {x.shape[1]} tokens: the conv state "
                         f"needs at least d_conv - 1 = {K}")
    out, xi, h = _scan(ctx, p, spec, x)
    return out, {"h": h[:, -1], "conv": xi[:, x.shape[1] - K:]}


def init_cache(spec: SSMSpec, batch: int, dtype=torch.float32, device=None):
    return {
        "h": torch.zeros((batch, spec.d_inner, spec.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner), dtype=dtype,
                            device=device),
    }


def decode(ctx: Ctx, p, spec: SSMSpec, x: torch.Tensor, cache) -> tuple[torch.Tensor, dict]:
    """One-step decode. x: (B, 1, d). Returns (out, the new state): the
    caller writes the state into its cache."""
    xz = cm.dense(ctx, p, "in_proj", x)
    xi, z = xz.chunk(2, dim=-1)  # (B, 1, di)
    buf = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)], dim=1)
    xi_c = torch.einsum("bkd,kd->bd", buf.to(torch.float32), p["conv_w"])[:, None]
    xi_c = F.silu(xi_c.to(x.dtype))
    a, b, Cc = _ssm_coeffs(ctx, p, spec, xi_c[:, 0])  # (B, di, n)
    h = a.to(torch.float32) * cache["h"] + b.to(torch.float32)
    y = torch.einsum("bdn,bn->bd", h, Cc.to(torch.float32))[:, None].to(x.dtype)
    y = (y + p["D"] * xi_c) * F.silu(z)
    return cm.dense(ctx, p, "out_proj", y), {"h": h, "conv": buf[:, 1:]}
