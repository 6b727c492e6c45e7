"""The program under test, built from the benchmark's configuration file.

The configuration file holds the published keys; this maps them onto the
port's ``ArchConfig`` and model. Everything of the port is imported inside
the functions, so importing the harness loads none of it.
"""
from __future__ import annotations


def arch_config(config: dict):
    from repro_torch.configs.base import ArchConfig

    if config.get("hidden_act", "silu") != "silu":
        raise ValueError("the dense decoder here is SwiGLU")
    return ArchConfig(
        name=config["name"], family="dense",
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"], n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        head_dim=config.get("head_dim"), rope_theta=float(config["rope_theta"]),
        tie_embeddings=bool(config["tie_word_embeddings"]))


def model(config: dict):
    from repro_torch.models.registry import build_model

    arch = arch_config(config)
    return arch, build_model(arch)
