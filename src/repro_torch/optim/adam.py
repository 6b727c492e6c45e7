"""Adam/AdamW over nested-dict trees of tensors.

The port of the JAX package's ``repro.optim.adam``. Used by the BRECQ
reconstruction loop (Adam, lr 1e-3 on the rounding logits, 4e-5 on the
activation step sizes, through a per-leaf ``lr_tree``). The state mirrors
the param tree: f32 moments ``m``/``v`` and an int32 ``count``; the bias
corrections ``1 - b**count`` are taken in f32, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import torch

from ..interop import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: Union[float, Callable] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None


def init(params: Params) -> dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _zip_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def update(cfg: AdamConfig, grads: Params, state: dict, params: Params,
           lr_tree: Optional[Params] = None) -> tuple[Params, dict]:
    """Returns (new_params, new_state). ``lr_tree`` optionally scales the
    learning rate per leaf (floats or 0-dim tensors)."""
    count = state["count"] + 1
    if cfg.grad_clip is not None:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    lr = cfg.lr(count) if callable(cfg.lr) else cfg.lr
    c32 = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.full_like(c32, cfg.b1), c32)
    b2c = 1.0 - torch.pow(torch.full_like(c32, cfg.b2), c32)

    def upd(g, m, v, p, lr_leaf):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        step = lr * lr_leaf * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr * lr_leaf * cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - step).to(p.dtype), m, v

    if lr_tree is None:
        lr_tree = tree_map(lambda _: 1.0, params)
    flat = _zip_map(upd, grads, state["m"], state["v"], params, lr_tree)
    pick = lambda i: _zip_map(lambda t: t[i], flat)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def lr(count):
        c = count.to(torch.float32)
        warm = c / max(warmup, 1)
        t = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * torch.where(c < warmup, warm, cos)

    return lr
