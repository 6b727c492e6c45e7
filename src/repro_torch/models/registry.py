"""Arch registry over the port's own configs: name -> (ArchConfig, model)."""
from __future__ import annotations

import importlib
from typing import Optional

from ..configs.base import ArchConfig
from .transformer import LM

# the archs whose configs the port carries (dense and MoE families)
ARCH_IDS = [
    "deepseek_moe_16b",
    "qwen3_moe_235b_a22b",
    "tinyllama_1_1b",
    # the paper-scale model used for BRECQ end-to-end experiments
    "brecq_lm_100m",
]

ALIASES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "tinyllama-1.1b": "tinyllama_1_1b",
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
    return LM(cfg, moe_impl=moe_impl)


def get_model(name: str, *, reduced: bool = False, moe_impl: Optional[str] = None):
    cfg = get_config(name, reduced=reduced)
    return cfg, build_model(cfg, moe_impl=moe_impl)
