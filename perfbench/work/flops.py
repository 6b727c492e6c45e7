"""Model FLOPs of a dense decoder, frozen from
``repro_torch/analysis/roofline.py`` (``active_params``, ``model_flops``)
with the parameter count written out for the dense family.

The config here is the benchmark's own dict (``configs/<name>.json``: the
published keys ``hidden_size``, ``num_hidden_layers``, ...).
"""
from __future__ import annotations


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "H": h,
            "K": cfg["num_key_value_heads"], "hd": cfg.get("head_dim") or d // h,
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "tied": bool(cfg["tie_word_embeddings"])}


def block_params(cfg: dict) -> float:
    """One layer: two norms, q/k/v/o and a SwiGLU MLP."""
    x = dims(cfg)
    d, hd = x["d"], x["hd"]
    attn = d * x["H"] * hd * 2 + d * x["K"] * hd * 2
    return float(2 * d + attn + 3 * d * x["ff"])


def active_params(cfg: dict) -> float:
    """Every parameter of a dense model: embedding, the untied head, the
    layers and the final norm (roofline.active_params, dense)."""
    x = dims(cfg)
    head = 0 if x["tied"] else x["d"] * x["V"]
    return float(x["V"] * x["d"] + head + x["d"]) + x["L"] * block_params(cfg)


def model_flops(cfg: dict, kind: str, tokens: int) -> float:
    """6*N*D for train, 2*N*D for inference (roofline.model_flops, one chip)."""
    n = active_params(cfg)
    return (6.0 if kind == "train" else 2.0) * n * tokens


def attention_flops(cfg: dict, keys: float) -> float:
    """The two dots of one query row against ``keys`` keys, every head of
    every layer."""
    x = dims(cfg)
    return 4.0 * x["L"] * x["H"] * x["hd"] * keys


def serve_token_flops(cfg: dict, pos: int, logits: bool) -> float:
    """One served token at position ``pos``: the layers' matmuls, attention
    over its ``pos + 1`` keys, and the head only where its logits are used."""
    x = dims(cfg)
    f = 2.0 * x["L"] * (block_params(cfg) - 2 * x["d"]) + attention_flops(cfg, pos + 1)
    return f + (2.0 * x["d"] * x["V"] if logits else 0.0)


def unit_iter_flops(cfg: dict, blocks: int, seqs: int, seq_len: int) -> float:
    """Forward and backward (3x the forward) of ``blocks`` layers over a
    minibatch of ``seqs`` causal sequences of ``seq_len`` tokens."""
    x = dims(cfg)
    mm = 2.0 * (block_params(cfg) - 2 * x["d"]) * seqs * seq_len
    causal_keys = seq_len * (seq_len + 1) / 2.0
    attn = 4.0 * x["H"] * x["hd"] * causal_keys * seqs
    return 3.0 * blocks * (mm + attn)
