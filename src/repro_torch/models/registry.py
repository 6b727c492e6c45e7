"""Arch registry over the port's own configs: name -> (ArchConfig, model)."""
from __future__ import annotations

import importlib

from ..configs.base import ArchConfig
from .transformer import LM

# the archs whose configs this slice carries (dense family)
ARCH_IDS = [
    "tinyllama_1_1b",
    # the paper-scale model used for BRECQ end-to-end experiments
    "brecq_lm_100m",
]

ALIASES = {"tinyllama-1.1b": "tinyllama_1_1b"}


def get_config(name: str, *, reduced: bool = False) -> ArchConfig:
    name = ALIASES.get(name, name).replace("-", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; this slice of the port "
                       f"carries {ARCH_IDS}")
    mod = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.configs.{name}")
    return mod.reduced() if reduced else mod.CONFIG


def build_model(cfg: ArchConfig) -> LM:
    """Instantiate the model object for a config."""
    return LM(cfg)


def get_model(name: str, *, reduced: bool = False):
    cfg = get_config(name, reduced=reduced)
    return cfg, build_model(cfg)
