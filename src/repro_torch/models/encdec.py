"""Whisper-style encoder-decoder backbone.

The port of the JAX package's ``repro.models.encdec``. The conv/audio
frontend is a stub: the batch carries precomputed frame embeddings
``frames`` (B, S_enc, d_model). The encoder is a bidirectional
transformer over the frames plus learned positions ``enc_pos``; the
decoder interleaves causal self-attention with tanh-gated cross-attention
over the encoder's normed output (``ctx.extras["memory"]``). Prefill,
decode and the forward are :class:`transformer.LM`'s over the decoder
stack: only ``begin`` differs, which encodes the frames (or takes a
given ``memory``). BRECQ walks the encoder stack, then the decoder stack
(``core.reconstruction.Walker``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ArchConfig
from . import common as cm
from .common import NO_QUANT, Ctx, QuantHook
from .transformer import (LM, StackDef, SubLayer, _layer, _maybe_remat, _norm, _norm_init,
                          _stack_trees)

Params = Any

ENC_SUB = SubLayer("attn", causal=False, ffn="mlp")
DEC_SUBS = (SubLayer("attn", ffn=None), SubLayer("xattn", ffn="mlp"))


def cfg_max_enc(cfg: ArchConfig) -> int:
    """Learned encoder positions: the longest encoder input taken."""
    return 32768


class EncDecLM(LM):
    """Encoder stack + decoder stack; the decoder cross-attends to the
    encoder."""

    def __init__(self, cfg: ArchConfig, *, moe_impl: str = "dense"):
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.enc_stack = StackDef("enc", cfg.n_layers, (ENC_SUB,))
        self.dec_stack = StackDef("dec", cfg.n_layers, DEC_SUBS)
        self.stacks = [self.dec_stack]  # BRECQ walks enc then dec (Walker)

    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen.device``, drawn from ``gen``."""
        cfg = self.cfg
        dev = gen.device
        params: dict = {
            "embed": cm.embed_init(gen, cfg.vocab, cfg.d_model),
            "enc_pos": torch.zeros((cfg_max_enc(cfg), cfg.d_model),
                                   dtype=torch.float32, device=dev),
            "enc_norm": _norm_init(cfg, dev),
            "final_norm": _norm_init(cfg, dev),
        }
        if not cfg.tie_embeddings:
            head = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                               dtype=torch.float32, device=dev)
            params["head"] = {"w": head * 0.02}
        for stack in (self.enc_stack, self.dec_stack):
            params[stack.name] = _stack_trees(
                [{f"sub{i}": self._init_sub(gen, s) for i, s in enumerate(stack.subs)}
                 for _ in range(stack.n)])
        return params

    # -- encoder ---------------------------------------------------------------

    def encode(self, params: Params, frames: torch.Tensor,
               quant: QuantHook = NO_QUANT, *,
               remat: Optional[str] = "none", act_shard=None) -> torch.Tensor:
        """frames: (B, S_enc, d_model) precomputed embeddings (stub
        frontend) -> the normed memory (B, S_enc, d_model); ``remat`` and
        ``act_shard`` as ``LM.forward``'s."""
        shard = act_shard or cm.no_shard
        B, S, _ = frames.shape
        if S > cfg_max_enc(self.cfg):
            raise ValueError(f"{S} encoder positions > {cfg_max_enc(self.cfg)}")
        pos = torch.arange(S, dtype=torch.int32, device=frames.device).expand(B, S)
        ctx = Ctx(cfg=self.cfg, positions=pos, quant=quant)
        x = shard(frames + params["enc_pos"][:S])
        block = _maybe_remat(lambda p, x: self.apply_block(ctx, self.enc_stack, p, x),
                             remat)
        for layer in range(self.enc_stack.n):
            x, _ = block(_layer(params["enc"], layer), x)
            x = shard(x)
        return _norm(self.cfg, params["enc_norm"], x)

    # -- joint forward -----------------------------------------------------------

    def begin(self, params: Params, batch: dict, quant: QuantHook = NO_QUANT,
              act_shard=None) -> tuple[torch.Tensor, Ctx]:
        """The decoder's stem: token embeddings, and a ctx whose
        ``extras["memory"]`` is ``batch["memory"]`` or the encoded
        ``batch["frames"]``."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        ctx = Ctx(cfg=self.cfg, positions=pos, quant=quant)
        if "memory" in batch:
            ctx.extras["memory"] = batch["memory"]
        else:
            ctx.extras["memory"] = self.encode(params, batch["frames"], quant,
                                               act_shard=act_shard)
        return cm.embed_lookup(ctx, params["embed"], tokens), ctx

    def forward(self, params: Params, batch: dict, quant: QuantHook = NO_QUANT,
                *, remat: Optional[str] = "none",
                act_shard=None) -> tuple[torch.Tensor, torch.Tensor]:
        """``LM.forward`` with the encoder's layers under ``remat`` and
        ``act_shard`` too."""
        if "memory" not in batch:
            batch = {**batch, "memory": self.encode(params, batch["frames"], quant,
                                                    remat=remat, act_shard=act_shard)}
        return super().forward(params, batch, quant, remat=remat, act_shard=act_shard)
