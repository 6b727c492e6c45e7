"""Architecture config schema + input shape definitions.

Every assigned arch provides ``CONFIG`` (exact published numbers) and
``reduced()`` (CPU-smoke-scale variant of the same family) through one
:class:`ArchConfig`. The dry-run, launcher and tests consume only this
schema.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEArch:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_k_dense: int = 0  # leading dense-FFN layers (deepseek)
    first_dense_ff: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    norm: str = "rms"  # rms | ln
    mlp_kind: str = "swiglu"  # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # attention pattern
    window: Optional[int] = None  # uniform sliding window (danube)
    local_global: Optional[Tuple[int, int]] = None  # (n_local, n_global) per group, gemma
    local_window: int = 1024
    # moe
    moe: Optional[MoEArch] = None
    # vlm: one cross-attn layer per `xattn_every` group
    xattn_every: Optional[int] = None
    n_patches: int = 1024
    # enc-dec (whisper): n_layers applies to BOTH encoder and decoder
    enc_dec: bool = False
    # xlstm: one sLSTM per group of `slstm_every` (rest mLSTM)
    slstm_every: Optional[int] = None
    xlstm_expansion: float = 2.0
    # hybrid (hymba)
    ssm_state: int = 0
    ssm_expansion: float = 2.0
    hymba_window: Optional[int] = 2048  # SWA for the attention heads in long ctx
    # applicability
    supports_long: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long:
        out.append("long_500k")
    return out
