"""Parameter counting for the roofline and the kernel audit.

The port of ``estimate_params`` from the JAX package's
``repro.dist.sharding``. JAX traces ``model.init`` under
``jax.eval_shape``; the port runs it under ``FakeTensorMode``, where every
tensor carries its shape and dtype and no storage, so even
llama-3.2-vision-90b (≈ 360 GB of f32) is counted without allocating.
"""
from __future__ import annotations

import math
from functools import lru_cache

from ..configs.base import ArchConfig


def fake_init(cfg: ArchConfig):
    """``model.init`` of ``cfg`` under ``FakeTensorMode``: the params tree
    with the real shapes and dtypes, and no storage. Imports torch only
    when called, so the roofline's constants import without it."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.registry import build_model

    model = build_model(cfg)
    with FakeTensorMode():
        return model.init(torch.Generator().manual_seed(0))


@lru_cache(maxsize=None)
def _count_params(cfg: ArchConfig) -> float:
    from ..interop import tree_leaves

    return float(sum(math.prod(leaf.shape) for leaf in tree_leaves(fake_init(cfg))))


def estimate_params(cfg: ArchConfig) -> float:
    """Exact parameter count for a config: the model's own ``init`` run
    under ``FakeTensorMode`` (shapes only, no allocation), cached per
    config. Consumed by the roofline's model FLOPs and bytes."""
    return _count_params(cfg)
