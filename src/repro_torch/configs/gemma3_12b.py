"""gemma3-12b [hf:google/gemma-3 family]: 5:1 local:global attention."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=256, qk_norm=True, mlp_kind="gelu",
    rope_theta=1e6, local_global=(5, 1), local_window=1024,
    supports_long=True,
    tie_embeddings=False,
    notes="5 local (window 1024) : 1 global per group; global-layer KV is "
          "sequence-sharded in long_500k. 262k vocab dominates bytes.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16, local_global=(2, 1), local_window=16)
