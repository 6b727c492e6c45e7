"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-*-Vision].

100 layers = 80 self-attn + 20 gated cross-attn (1 per group of 5).
The vision tower is a STUB per assignment: input_specs supplies
precomputed patch embeddings (B, n_patches, d_model).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, rope_theta=500000.0, tie_embeddings=False,
    xattn_every=5, n_patches=1024,
    notes="tanh-gated cross-attn layers; image frontend stubbed.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, xattn_every=2, n_patches=16)
