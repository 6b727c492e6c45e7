"""xlstm-350m [arXiv:2405.04517]: sLSTM + mLSTM blocks, 24L, d=1024."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, slstm_every=6, xlstm_expansion=2.0,
    supports_long=True,
    tie_embeddings=False,
    notes="d_ff=0: xLSTM blocks carry their own 2x up/down projections; "
          "1 sLSTM per 6 blocks. O(1) decode state -> long_500k runs.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=2, n_kv_heads=2,
        vocab=256, slstm_every=3)
