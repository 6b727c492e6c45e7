"""Deterministic synthetic corpus with learnable structure (numpy only).

A sparse first-order Markov chain over the vocab (each token has k
successors with zipf-ish weights) plus periodic copy segments. Samples
are token-identical to the JAX package's ``repro.data.Corpus`` for the
same (seed, host, step), so both packages serve the same prompts and
calibrate on the same batches (``make_batches``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab: int
    branching: int = 12  # successors per token
    copy_period: int = 64  # every N tokens, re-emit an earlier span
    copy_len: int = 8
    seed: int = 1234


class Corpus:
    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = cfg.branching
        self.successors = rng.integers(0, cfg.vocab, (cfg.vocab, k)).astype(np.int32)
        w = 1.0 / np.arange(1, k + 1) ** 1.2
        self.weights = (w / w.sum()).astype(np.float64)

    def sample(self, batch: int, seq: int, *, seed: int, host: int = 0,
               step: int = 0) -> np.ndarray:
        """(batch, seq) int32 tokens; deterministic in (seed, host, step)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, seed, host, step]))
        toks = np.empty((batch, seq), np.int32)
        cur = rng.integers(0, cfg.vocab, batch)
        choices = rng.choice(cfg.branching, size=(batch, seq), p=self.weights)
        toks[:, 0] = cur
        for t in range(1, seq):
            cur = self.successors[cur, choices[:, t]]
            # copy mechanism: splice in an earlier span periodically
            if cfg.copy_period and t % cfg.copy_period == 0 and t > cfg.copy_len:
                src = t - cfg.copy_len - 1
                toks[:, t - cfg.copy_len: t] = toks[:, src: src + cfg.copy_len]
                cur = toks[:, t - 1]
            toks[:, t] = cur
        return toks


def make_batches(corpus: Corpus, n_batches: int, batch: int, seq: int,
                 *, seed: int, host: int = 0, start_step: int = 0,
                 extras_fn=None) -> list[dict]:
    """List of {'tokens': (B,S) int64} CPU batches (+ ``extras_fn(batch,
    seq, step)``'s entries), token-identical to the JAX package's
    ``make_batches``; ``quantize``/``evaluate`` move them to the params'
    device."""
    import torch

    out = []
    for i in range(n_batches):
        toks = corpus.sample(batch, seq, seed=seed, host=host, step=start_step + i)
        b = {"tokens": torch.from_numpy(toks.astype(np.int64))}
        if extras_fn is not None:
            b.update(extras_fn(batch, seq, start_step + i))
        out.append(b)
    return out


def arch_extras_fn(cfg):
    """Per-arch stub-modality extras (VLM ``patches`` / whisper ``frames``)
    as f32 CPU tensors, value for value the JAX package's draws; ``None``
    for the text-only archs."""
    import torch

    if cfg.family == "vlm":
        def fn(batch, seq, step):
            rng = np.random.default_rng(np.random.SeedSequence([7, step]))
            return {"patches": torch.from_numpy(
                rng.normal(size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32))}

        return fn
    if cfg.enc_dec:
        def fn(batch, seq, step):
            rng = np.random.default_rng(np.random.SeedSequence([11, step]))
            return {"frames": torch.from_numpy(
                rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32))}

        return fn
    return None
