"""h2o-danube-3-4b [arXiv:2401.16818]: llama+mistral mix with SWA."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab=32000, head_dim=120, window=4096, supports_long=True,
    tie_embeddings=False,
    notes="uniform sliding-window attention (mistral-style) -> bounded "
          "decode cache -> long_500k runs.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16, window=32)
