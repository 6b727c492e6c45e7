"""Arch registry over the port's own configs: name -> (ArchConfig, model)."""
from __future__ import annotations

import importlib
from typing import Optional

from ..configs.base import ArchConfig
from .encdec import EncDecLM
from .transformer import LM

# the JAX registry's archs
ARCH_IDS = [
    "xlstm_350m",
    "deepseek_moe_16b",
    "qwen3_moe_235b_a22b",
    "llama32_vision_90b",
    "internlm2_20b",
    "tinyllama_1_1b",
    "h2o_danube3_4b",
    "gemma3_12b",
    "whisper_small",
    "hymba_1_5b",
    # the paper-scale model used for BRECQ end-to-end experiments
    "brecq_lm_100m",
]

ALIASES = {
    "xlstm-350m": "xlstm_350m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "internlm2-20b": "internlm2_20b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "gemma3-12b": "gemma3_12b",
    "whisper-small": "whisper_small",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(name: str, *, reduced: bool = False) -> ArchConfig:
    name = ALIASES.get(name, name).replace("-", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; the port carries {ARCH_IDS}")
    mod = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.configs.{name}")
    return mod.reduced() if reduced else mod.CONFIG


def build_model(cfg: ArchConfig, *, moe_impl: Optional[str] = None) -> LM:
    """Instantiate the model object for a config."""
    if moe_impl is None:
        # exact token-choice for small models; capacity routing at scale
        moe_impl = "capacity" if (cfg.moe and cfg.moe.n_experts >= 16) else "dense"
    if cfg.enc_dec:
        return EncDecLM(cfg, moe_impl=moe_impl)
    return LM(cfg, moe_impl=moe_impl)


def get_model(name: str, *, reduced: bool = False, moe_impl: Optional[str] = None):
    cfg = get_config(name, reduced=reduced)
    return cfg, build_model(cfg, moe_impl=moe_impl)
