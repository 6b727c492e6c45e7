"""Mixture-of-Experts layers (deepseek-moe, qwen3-moe).

The port of the JAX package's ``repro.models.moe``. Two execution paths
share one parameterization:

* ``impl='dense'``: every expert runs on every token, combined by the
  sparse gate matrix. Exact token-choice semantics; reduced configs.
* ``impl='capacity'``: the deployment path. Per sequence, each expert
  takes its top-C tokens (gather -> stacked-expert matmuls -> combine);
  tokens beyond capacity are dropped, as in the JAX package.

The router stays FP under quantization; expert weights are stacked
(E, d_in, d_out), and packed expert nodes run through the grouped ``qmm``
tier (``qmatmul_grouped`` on the card), which reads the stacked codes
directly.

Dispatch stays per sequence, as the JAX package's vmap over B: no
sequence's tokens enter another's experts, so a non-finite stream cannot
leak into another through ``0 * NaN``, and each engine slot stays
independent of the others. The capacity combine is a one-hot product per
sequence, whose additions run in a fixed order on the card (a scatter-add
would use float atomics there, and the result would change from run to
run).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import mlp as mlp_mod
from .common import Ctx


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    norm_topk: bool = True
    impl: str = "dense"  # 'dense' | 'capacity'


def init(gen: torch.Generator, spec: MoESpec):
    scale = 1.0 / math.sqrt(spec.d_model)
    dev = gen.device
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff

    def uniform(*shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        return w.uniform_(-scale, scale, generator=gen)

    p = {
        "router": {"w": torch.randn((d, e), generator=gen, dtype=torch.float32,
                                    device=dev) * scale},
        "w_gate": {"w": uniform(e, d, f)},
        "w_up": {"w": uniform(e, d, f)},
        "w_down": {"w": uniform(e, f, d)},
    }
    if spec.n_shared:
        p["shared"] = mlp_mod.init(gen, _shared_spec(spec))
    return p


def _shared_spec(spec: MoESpec) -> mlp_mod.MLPSpec:
    return mlp_mod.MLPSpec(spec.d_model, spec.d_ff * spec.n_shared, "swiglu")


def _router_probs(ctx: Ctx, p, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    # the router is FP: it bypasses the quant hook on purpose. (..., d) -> (..., E)
    return torch.softmax(x.to(torch.float32) @ p["router"]["w"], dim=-1)


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k on the last axis as the JAX package computes it: an ascending
    sort, the last k indices reversed. The sort is stable, so ties (the
    capacity path's -inf rows) resolve the same way on every run."""
    _, idx = torch.sort(x, dim=-1, stable=True)
    idx = idx[..., x.shape[-1] - k:].flip(-1)
    return torch.gather(x, -1, idx), idx


def _topk_gates(probs: torch.Tensor, spec: MoESpec) -> tuple[torch.Tensor, torch.Tensor]:
    gates, eids = _topk(probs, spec.top_k)  # (..., k)
    if spec.norm_topk:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eids


def _expert_mm(ctx: Ctx, p, name: str, xe: torch.Tensor) -> torch.Tensor:
    """One stacked-expert contraction: (..., E, C, K) @ (E, K, N).

    Packed nodes run the grouped ``qmm`` tier on the stacked int codes.
    Activation fake-quant is applied by :func:`_expert_ffn` (one quantized
    activation shared by the gate and up matmuls), so the hook is told not
    to apply it again.
    """
    node = p[name]
    path = f"{ctx.scope}/{name}"
    if "qscale" in node:
        return ctx.quant.packed_matmul(path, xe, node, apply_act=False)
    w = ctx.quant.weight(path, node["w"])
    return torch.einsum("...ecd,edf->...ecf", xe, w.to(xe.dtype))


def _expert_ffn(ctx: Ctx, p, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, d) or (B, E, C, d) -> same, through the stacked SwiGLU experts."""
    xe = ctx.quant.act(f"{ctx.scope}/w_gate", xe)
    g = _expert_mm(ctx, p, "w_gate", xe)
    u = _expert_mm(ctx, p, "w_up", xe)
    h = ctx.quant.act(f"{ctx.scope}/w_down", F.silu(g) * u)
    return _expert_mm(ctx, p, "w_down", h)


def capacity(spec: MoESpec, S: int) -> int:
    """Tokens each expert takes from a sequence of ``S`` (Python's
    ``round``, half to even, as in the JAX package)."""
    cap = int(max(1, round(S * spec.top_k * spec.capacity_factor / spec.n_experts)))
    return min(cap, S)


def dispatch(gates: torch.Tensor, eids: torch.Tensor, spec: MoESpec
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence capacity dispatch: (scores, token ids), both (B, E,
    cap). A score is the token's gate for that expert, or -inf where the
    expert has fewer takers than its capacity."""
    B, S, _ = eids.shape
    # (B, E, S): gate weight if token s picked expert e (a token's top-k
    # experts are distinct, so each entry is written at most once)
    sel = torch.full((B, spec.n_experts, S), -math.inf, dtype=torch.float32,
                     device=gates.device)
    sel.scatter_(1, eids.transpose(1, 2), gates.transpose(1, 2).to(torch.float32))
    return _topk(sel, capacity(spec, S))


def dropped_picks(ctx: Ctx, p, spec: MoESpec, x: torch.Tensor) -> tuple[int, int]:
    """(token, expert) picks of ``x`` (B, S, d) that capacity routing
    drops, and all picks."""
    gates, eids = _topk_gates(_router_probs(ctx, p, spec, x), spec)
    scores, _ = dispatch(gates, eids, spec)
    picks = eids.numel()
    return picks - int(torch.isfinite(scores).sum()), picks


def apply(ctx: Ctx, p, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    E = spec.n_experts
    probs = _router_probs(ctx, p, spec, x)  # (B, S, E)
    gates, eids = _topk_gates(probs, spec)  # (B, S, k)

    if spec.impl == "dense":
        # combine matrix (B, S, E): gate weight where selected, else 0
        comb = torch.zeros((B, S, E), dtype=x.dtype, device=x.device)
        comb.scatter_(-1, eids, gates.to(x.dtype))
        # all experts on all tokens (exact; reduced configs only)
        ye = _expert_ffn(ctx, p, x[:, None].expand(B, E, S, d))  # (B, E, S, d)
        return torch.einsum("bse,besd->bsd", comb, ye) + _shared(ctx, p, spec, x)

    scores, tidx = dispatch(gates, eids, spec)  # (B, E, cap)
    cap = tidx.shape[-1]
    w = torch.where(torch.isfinite(scores), scores, 0.0).to(x.dtype)
    xe = x[torch.arange(B, device=x.device)[:, None, None], tidx]  # (B, E, cap, d)
    ye = _expert_ffn(ctx, p, xe) * w[..., None]
    # per-sequence combine as a one-hot product: a fixed order of additions
    onehot = F.one_hot(tidx.reshape(B, E * cap), S).to(x.dtype)  # (B, E*cap, S)
    out = torch.bmm(onehot.transpose(1, 2), ye.reshape(B, E * cap, d))
    return out + _shared(ctx, p, spec, x)


def _shared(ctx: Ctx, p, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    if not spec.n_shared:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return mlp_mod.apply(ctx.scoped("shared"), p["shared"], _shared_spec(spec), x)


def aux_loss(ctx: Ctx, p, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss (used by the training loop)."""
    probs = _router_probs(ctx, p, spec, x)  # (B, S, E)
    _, eids = _topk_gates(probs, spec)
    onehot = F.one_hot(eids, spec.n_experts).sum(2).to(torch.float32)  # (B, S, E)
    frac_tokens = onehot.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return spec.n_experts * torch.sum(frac_tokens * frac_probs)
