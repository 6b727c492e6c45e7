"""brecq-lm-100m: the paper-scale model for end-to-end BRECQ experiments.

Plays the role ResNet-18 plays in the paper: small enough to train for a
few hundred steps in-framework, big enough that 2-bit RTN collapses and
block reconstruction visibly recovers it.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="brecq-lm-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=2048,
    vocab=8192, tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512)
