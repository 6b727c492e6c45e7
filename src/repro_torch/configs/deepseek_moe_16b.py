"""deepseek-moe-16b [arXiv:2401.06066]: 2 shared + 64 routed top-6."""
import dataclasses

from .base import ArchConfig, MoEArch

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400,
    moe=MoEArch(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                first_k_dense=1, first_dense_ff=10944),
    tie_embeddings=False,
    notes="fine-grained experts; layer 0 keeps a dense FFN (hf config "
          "first_k_dense_replace=1).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=256,
        moe=MoEArch(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1,
                    first_k_dense=1, first_dense_ff=128))
