"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3 family]: 128 experts top-8, GQA kv=4."""
import dataclasses

from .base import ArchConfig, MoEArch

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    tie_embeddings=False,
    moe=MoEArch(n_experts=128, top_k=8, d_ff_expert=1536),
    notes="per-head q/k RMS norm (qwen3); no shared experts.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256, head_dim=16,
        moe=MoEArch(n_experts=8, top_k=2, d_ff_expert=96))
