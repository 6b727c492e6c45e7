"""whisper-small [arXiv:2212.04356]: enc-dec, conv frontend stubbed.

Backbone only per assignment: input_specs provides precomputed frame
embeddings. Positional scheme adapted to the substrate's RoPE
(DESIGN.md §2); LayerNorm + GELU as in the original.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, norm="ln", mlp_kind="gelu", enc_dec=True,
    tie_embeddings=False,
    notes="12 encoder + 12 decoder layers; decoder = self-attn + "
          "cross-attn + MLP. long_500k skipped (full attention decoder).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256)
