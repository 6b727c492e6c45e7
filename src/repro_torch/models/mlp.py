"""Feed-forward variants: SwiGLU (llama family) and GELU."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import common as cm
from .common import Ctx


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"  # 'swiglu' | 'gelu'


def init(gen: torch.Generator, spec: MLPSpec):
    if spec.kind == "swiglu":
        return {
            "w_gate": cm.dense_init(gen, spec.d_model, spec.d_ff),
            "w_up": cm.dense_init(gen, spec.d_model, spec.d_ff),
            "w_down": cm.dense_init(gen, spec.d_ff, spec.d_model),
        }
    return {
        "w_up": cm.dense_init(gen, spec.d_model, spec.d_ff),
        "w_down": cm.dense_init(gen, spec.d_ff, spec.d_model),
    }


def apply(ctx: Ctx, p, spec: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.kind == "swiglu":
        g = cm.dense(ctx, p, "w_gate", x)
        u = cm.dense(ctx, p, "w_up", x)
        return cm.dense(ctx, p, "w_down", F.silu(g) * u)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(cm.dense(ctx, p, "w_up", x), approximate="tanh")
    return cm.dense(ctx, p, "w_down", h)
