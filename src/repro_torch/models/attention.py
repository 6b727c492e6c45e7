"""GQA / sliding-window / cross attention with KV caches.

A single :class:`AttnSpec` covers the attention variants of the dense,
MoE, VLM and encoder-decoder families. Caches are ring buffers for
windowed layers and linear buffers otherwise. The cache, dense or paged,
is updated in place (the JAX package donates it to the jitted step
instead); ``prefill``/``decode`` return it for symmetry. Cross-attention
(``apply(kv_x=)``, ``xattn_cache``, ``xattn_decode``) attends over a
``memory`` (VLM patches, the encoder's output): no rope, no mask.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import common as cm
from .common import Ctx


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window size, None = global
    causal: bool = True
    use_rope: bool = True
    qk_norm: bool = False  # qwen3-style per-head RMS on q/k
    q_chunk: int = 1024
    kv_chunk: int = 1024


def init(gen: torch.Generator, spec: AttnSpec):
    p = {
        "wq": cm.dense_init(gen, spec.d_model, spec.n_heads * spec.head_dim),
        "wk": cm.dense_init(gen, spec.d_model, spec.n_kv_heads * spec.head_dim),
        "wv": cm.dense_init(gen, spec.d_model, spec.n_kv_heads * spec.head_dim),
        "wo": cm.dense_init(gen, spec.n_heads * spec.head_dim, spec.d_model),
    }
    if spec.qk_norm:
        p["q_norm"] = cm.rmsnorm_init(spec.head_dim, gen.device)
        p["k_norm"] = cm.rmsnorm_init(spec.head_dim, gen.device)
    return p


def _project_qkv(ctx: Ctx, p, spec: AttnSpec, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    kv_src = x if kv_x is None else kv_x
    q = cm.split_heads(cm.dense(ctx, p, "wq", x), spec.n_heads, spec.head_dim)
    k = cm.split_heads(cm.dense(ctx, p, "wk", kv_src), spec.n_kv_heads, spec.head_dim)
    v = cm.split_heads(cm.dense(ctx, p, "wv", kv_src), spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = cm.rmsnorm(p["q_norm"], q)
        k = cm.rmsnorm(p["k_norm"], k)
    return q, k, v


def _attend_prompt(ctx: Ctx, p, spec: AttnSpec, x: torch.Tensor):
    q, k, v = _project_qkv(ctx, p, spec, x)
    if spec.use_rope:
        q = cm.apply_rope(q, ctx.positions, spec.rope_theta)
        k = cm.apply_rope(k, ctx.positions, spec.rope_theta)
    out = cm.local_attention(
        q, k, v, ctx.positions, ctx.positions, causal=spec.causal,
        window=spec.window, q_chunk=spec.q_chunk, kv_chunk=spec.kv_chunk,
        iota_pos=True)
    return out, k, v


def apply(ctx: Ctx, p, spec: AttnSpec, x: torch.Tensor,
          kv_x: Optional[torch.Tensor] = None,
          kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill without cache write).

    ``kv_x`` switches to cross-attention against that source: no rope,
    no mask (keys at ``kv_pos``, else 0..Skv-1)."""
    B, S = x.shape[:2]
    if kv_x is None:
        out, _, _ = _attend_prompt(ctx, p, spec, x)
    else:
        q, k, v = _project_qkv(ctx, p, spec, x, kv_x)
        Skv = kv_x.shape[1]
        if kv_pos is None:
            kv_pos = torch.arange(Skv, device=x.device).expand(B, Skv)
        out = cm.local_attention(
            q, k, v, ctx.positions, kv_pos, causal=False, window=None,
            q_chunk=spec.q_chunk, kv_chunk=spec.kv_chunk)
    return cm.dense(ctx, p, "wo", out.reshape(B, S, spec.n_heads * spec.head_dim))


def init_cache(spec: AttnSpec, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Cache dict. Windowed layers use a ring buffer of size ``window``."""
    slots = min(max_len, spec.window) if spec.window is not None else max_len
    shape = (batch, slots, spec.n_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    }


def prefill(ctx: Ctx, p, spec: AttnSpec, x: torch.Tensor, cache):
    """Run full attention over the prompt and fill the cache (in place)."""
    B, S = x.shape[:2]
    out, k, v = _attend_prompt(ctx, p, spec, x)
    slots = cache["k"].shape[1]
    pos = ctx.positions.to(torch.int32)
    for name, val in (("k", k), ("v", v), ("pos", pos)):
        cm.put_prompt(cache[name], val, slots)
    out = out.reshape(B, S, spec.n_heads * spec.head_dim)
    return cm.dense(ctx, p, "wo", out), cache


def decode(ctx: Ctx, p, spec: AttnSpec, x: torch.Tensor, cache):
    """Cached decode: append C new tokens to the cache (in place), attend
    over it. ``ctx.positions`` is (B, C) with the tokens' absolute
    positions: C = 1 for plain decode, C > 1 for a chunked-prefill step.
    ``cache`` is the dense ring buffer from :func:`init_cache` or one
    layer's paged-pool slice (serve engine), dispatched through
    ``cm.is_paged``; the paged path reads the block tables from
    ``ctx.extras["paged"]``."""
    B, C = x.shape[:2]
    q, k, v = _project_qkv(ctx, p, spec, x)
    if spec.use_rope:
        q = cm.apply_rope(q, ctx.positions, spec.rope_theta)
        k = cm.apply_rope(k, ctx.positions, spec.rope_theta)
    if cm.is_paged(cache):
        pg = ctx.extras["paged"]
        cm.paged_append(cache, k, v, pg["block_tables"], ctx.positions,
                        pg["page_size"])
        out = cm.paged_attend(q, cache, pg["block_tables"], ctx.positions,
                              pg["page_size"], window=spec.window,
                              backend=pg.get("backend", "auto"))
        out = out.reshape(B, C, spec.n_heads * spec.head_dim)
        return cm.dense(ctx, p, "wo", out), cache
    slots = cache["k"].shape[1]
    pos = ctx.positions.to(torch.int32)  # (B, C)
    slot = (pos % slots).long()
    for name, val in (("k", k), ("v", v), ("pos", pos)):
        cm.put_slots(cache[name], slot, val)
    # a sharded step replicates the (tiny) query so attention reads the
    # cache in place, and lays out the scores like the cache's slots
    shard = ctx.extras.get("cache_shard")
    if shard is not None:
        q = shard(q, "q")
    out = cm.decode_attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                           cache["pos"], pos, window=spec.window, shard=shard)
    out = out.reshape(B, C, spec.n_heads * spec.head_dim)
    return cm.dense(ctx, p, "wo", out), cache


# cross-attention cache: static K/V computed once from the memory --------------


def xattn_cache(ctx: Ctx, p, spec: AttnSpec, memory: torch.Tensor):
    B, Sm = memory.shape[:2]
    k = cm.dense(ctx, p, "wk", memory).reshape(B, Sm, spec.n_kv_heads, spec.head_dim)
    v = cm.dense(ctx, p, "wv", memory).reshape(B, Sm, spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        k = cm.rmsnorm(p["k_norm"], k)
    return {"k": k, "v": v}


def xattn_decode(ctx: Ctx, p, spec: AttnSpec, x: torch.Tensor, xcache) -> torch.Tensor:
    """One decode token's cross-attention over the cached memory K/V."""
    B = x.shape[0]
    q = cm.dense(ctx, p, "wq", x).reshape(B, 1, spec.n_heads, spec.head_dim)
    if spec.qk_norm:
        q = cm.rmsnorm(p["q_norm"], q)
    Sm = xcache["k"].shape[1]
    k_pos = torch.arange(Sm, device=x.device).expand(B, Sm)
    cur = torch.full((B, 1), Sm, dtype=torch.int32, device=x.device)
    out = cm.decode_attend(q, xcache["k"].to(q.dtype), xcache["v"].to(q.dtype),
                           k_pos, cur, window=None)
    out = out.reshape(B, 1, spec.n_heads * spec.head_dim)
    return cm.dense(ctx, p, "wo", out)
