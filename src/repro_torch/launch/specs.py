"""Shape-only input stand-ins for every (arch x shape) cell.

The port of the JAX package's ``repro.launch.specs``: trees of tensors
made under ``FakeTensorMode`` (shape and dtype, no storage) in place of
``jax.ShapeDtypeStruct``. The dry run traces its steps against these. As
in JAX, the VLM patch embeddings and whisper's frame embeddings are
precomputed (B, P|S, d) bf16 inputs.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..dist.sharding import fake_init


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mode=None) -> dict:
    """Batch tree of fake tensors for train/prefill steps."""
    B, S = shape.global_batch, shape.seq_len
    with mode or _fake_mode():
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                           dtype=torch.bfloat16)
        if cfg.enc_dec:
            batch["frames"] = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16)
    return batch


def decode_specs(cfg: ArchConfig, shape: ShapeSpec, model, mode=None) -> tuple:
    """(token batch, cache, pos) stand-ins for one decode step with a KV
    cache of ``shape.seq_len`` tokens."""
    B, S = shape.global_batch, shape.seq_len
    with mode or _fake_mode():
        tokens = torch.empty((B, 1), dtype=torch.int32)
        cache = model.init_cache(B, S, torch.bfloat16)
        pos = torch.empty((B,), dtype=torch.int32)
    return {"tokens": tokens}, cache, pos


def params_specs(model, mode=None) -> dict:
    """The model's params as fake tensors (``dist.sharding.fake_init``)."""
    return fake_init(model.cfg, mode)
