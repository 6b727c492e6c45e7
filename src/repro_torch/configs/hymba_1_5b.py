"""hymba-1.5b [arXiv:2411.13676]: parallel attention + mamba heads."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, ssm_state=16, ssm_expansion=2.0,
    hymba_window=2048, supports_long=True,
    tie_embeddings=False,
    notes="each block runs attention heads and a selective-SSM head on "
          "the same input, outputs averaged. Attention uses SWA(2048) so "
          "the decode state stays bounded -> long_500k runs.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16, ssm_state=8, hymba_window=32)
