"""Shared building blocks of the models, in plain PyTorch.

Conventions follow the JAX package's ``repro.models.common``:

* Params are nested dicts of tensors. A linear layer is ``{'w': (in,
  out)}`` (+ optional ``'b'``); weight layout is (reduction_dim,
  output_dim).
* Every matmul goes through :func:`dense`, which consults the quant hook
  ``ctx.quant``. A node with a ``qscale`` sibling holds packed int codes
  and runs through ``QuantHook.packed_matmul`` -> ``qmm``.
* Attention is written out (no fused SDPA): it reproduces the JAX math,
  including the online softmax of :func:`chunked_attention`.
* The paged KV cache of the serve engine (last section) is written in
  place: :func:`paged_append` scatters into the pool tensors it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..kernels.kvattn.ref import paged_view

Params = Any


# ---------------------------------------------------------------------------
# quant hook
# ---------------------------------------------------------------------------


class QuantHook:
    """Interface the models call; the default is a no-op (FP model).

    ``weight(name, w)`` / ``act(name, x)`` return the (possibly
    fake-quantized) weight / activation. When a params node carries
    packed int codes (a ``qscale`` sibling), :func:`dense`/:func:`lm_head`
    hand the whole matmul to ``packed_matmul``, which runs the packed
    ``qmm`` dispatcher. ``packed_backend`` picks its execution path
    (``'auto'``: the CUDA kernels for CUDA tensors, the plain PyTorch
    version for CPU tensors; ``'torch'``; ``'cuda'``).
    """

    packed_backend: str = "auto"

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        return w

    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def packed_matmul(self, name: str, x: torch.Tensor, node: Params,
                      apply_act: bool = True) -> torch.Tensor:
        from ..kernels.qmatmul.ops import from_node, qmm

        if apply_act:
            x = self.act(name, x)
        return qmm(x, from_node(node, x.shape[-1], path=name),
                   backend=self.packed_backend)


NO_QUANT = QuantHook()


@dataclasses.dataclass
class Ctx:
    """Per-forward context threaded through blocks."""

    cfg: Any
    positions: torch.Tensor  # (B, S) absolute positions of the current tokens
    quant: QuantHook = dataclasses.field(default_factory=lambda: NO_QUANT)
    extras: dict = dataclasses.field(default_factory=dict)
    scope: str = ""  # name scope for quant hook paths

    def scoped(self, name: str) -> "Ctx":
        return dataclasses.replace(self, scope=f"{self.scope}/{name}" if self.scope else name)


# ---------------------------------------------------------------------------
# initialisation helpers (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> Params:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=dtype, device=gen.device)
    return {"w": w.uniform_(-scale, scale, generator=gen)}


def dense(ctx: Ctx, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Quant-aware linear: x @ W. The only matmul entry point."""
    node = p[name]
    path = f"{ctx.scope}/{name}" if ctx.scope else name
    if "qscale" in node:
        y = ctx.quant.packed_matmul(path, x, node)
    else:
        w = ctx.quant.weight(path, node["w"])
        x = ctx.quant.act(path, x)
        y = x @ w.to(x.dtype)
    if "b" in node:
        y = y + node["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance reduced in f32; normalization stays in x.dtype."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["g"].to(x.dtype)


def layernorm_init(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True).to(x.dtype)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu) * inv * p["g"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int) -> Params:
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device)
    return {"table": table * 0.02}


def embed_lookup(ctx: Ctx, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    if "table_qscale" in p:  # int8 deployment table: gather, then dequant
        rows = p["table"][tokens.long()].to(torch.float32)
        return rows * p["table_qscale"][0]
    table = ctx.quant.weight("embed/table", p["table"])
    return table[tokens.long()]


def lm_head(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Output projection to vocab logits; may be tied to the embedding.

    ``p`` is a head node (``{"w": (d, V)}``, possibly packed) or, with
    tied embeddings, the embedding node (``{"table": (V, d)}``, possibly
    int8 with ``table_qscale``). A tied int8 table is dequantized whole
    on every call, as in the JAX package.
    """
    if "qscale" in p:
        return ctx.quant.packed_matmul("head/w", x, p)
    if "table_qscale" in p:  # tied to an int8 table: (V, d) -> (d, V)
        w = (p["table"].to(torch.float32) * p["table_qscale"][0]).T
    elif "table" in p:  # tied FP table
        w = ctx.quant.weight("head/w", p["table"].T)
        x = ctx.quant.act("head/w", x)
    else:
        w = ctx.quant.weight("head/w", p["w"])  # (d, vocab)
        x = ctx.quant.act("head/w", x)
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# activations with JAX's formulas, and the associative scan
# ---------------------------------------------------------------------------


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0) at every x
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def associative_scan(fn, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(left, right) -> combined`` (tuples of tensors).

    The recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half, then fill in the even positions, so the operands meet in
    JAX's order. It runs about 2 * log2(S) rounds of whole-tensor ops and
    stays differentiable.
    """
    dim %= elems[0].ndim
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    odd = associative_scan(fn, fn(tuple(sl(e, 0, -1, 2) for e in elems),
                                  tuple(sl(e, 1, None, 2) for e in elems)), dim)
    left = odd if n % 2 else tuple(sl(e, 0, -1) for e in odd)
    even = fn(left, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim``; ``a`` may hold one more."""
    nb = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, nb), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == nb:
        return pairs
    return torch.cat([pairs, a.narrow(dim, nb, 1)], dim=dim)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V), labels (B,S)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


MASK_VALUE = -1e30


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask. ``window`` enables sliding-window attn."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return m


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain attention. q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) with GQA repeat."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    if K != H:
        rep = H // K
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if mask is not None:
        m = mask[:, None] if mask.ndim == 3 else mask
        scores = torch.where(m, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      iota_pos: bool = False) -> torch.Tensor:
    """Flash-style attention: online softmax over KV chunks, looped over Q
    chunks, in the same chunk order and arithmetic as the JAX version.

    ``iota_pos=True`` asserts positions are plain aranges; with causal
    attention over equal square chunks, KV chunks wholly above the
    diagonal (or outside the window) are skipped, as in the JAX triangle
    unroll. A length that is not a multiple of its chunk ends in a
    shorter chunk (the JAX version asserts whole chunks; Whisper's 1,500
    frames need the remainder); the triangle skip then stays off.
    q: (B,Sq,H,hd) k/v: (B,Sk,K,hd) q_pos: (B,Sq) k_pos: (B,Sk)
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    rep = H // K
    nq, nk = -(-Sq // q_chunk), -(-Sk // kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    triangle = (iota_pos and causal and q_chunk == kv_chunk and Sq == Sk
                and Sq % q_chunk == 0 and nq <= 8)

    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpi = q_pos[:, i * q_chunk:(i + 1) * q_chunk]
        lo, hi = 0, nk
        if triangle:
            hi = i + 1
            if window is not None:
                lo = max(0, (i * q_chunk - (window - 1)) // kv_chunk)
        qn = qi.shape[1]
        m = torch.full((B, H, qn), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, qn), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qn, hd), dtype=torch.float32, device=q.device)
        for j in range(lo, hi):
            ki = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vi = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            kpi = k_pos[:, j * kv_chunk:(j + 1) * kv_chunk]
            if rep != 1:
                ki = ki.repeat_interleave(rep, dim=2)
                vi = vi.repeat_interleave(rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki).to(torch.float32) * scale
            if causal or window is not None:
                delta = qpi[:, None, :, None] - kpi[:, None, None, :]
                mask = delta >= 0 if causal else torch.ones_like(delta, dtype=torch.bool)
                if window is not None:
                    mask = mask & (delta < window)
                s = torch.where(mask, s, MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vi.dtype), vi).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))  # (B, qc, H, hd)
    return torch.cat(outs, dim=1)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  k_pos: torch.Tensor, cur_pos: torch.Tensor, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """Decode attention against a cache for one or a few query tokens.

    GQA-native (no head repeat of the cache). q: (B,C,H,hd); caches
    (B,S,K,hd); k_pos (B,S) absolute positions of cache slots (-1 for
    empty); cur_pos (B,C) current position of each query token.
    """
    B, C, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, C, K, G, hd)
    s = torch.einsum("bckgd,bskd->bckgs", qg, k_cache).to(torch.float32)
    s = s / math.sqrt(hd)
    valid = (k_pos[:, None] >= 0) & (k_pos[:, None] <= cur_pos[..., None])
    if window is not None:
        valid = valid & (cur_pos[..., None] - k_pos[:, None] < window)
    s = torch.where(valid[:, :, None, None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bckgs,bskd->bckgd", p, v_cache)
    return out.reshape(B, C, H, hd)


# ---------------------------------------------------------------------------
# paged KV cache (serve engine)
# ---------------------------------------------------------------------------
#
# The serve engine stores KV in a global page pool per attention layer
# instead of one dense (B, S, K, hd) buffer per stream. A *page* holds
# ``page_size`` consecutive token slots for every kv head; a stream owns
# an ordered list of pages (its *block table* row, shared by all layers
# since every layer caches the same token sequence). Token at absolute
# position ``t`` always lives at row ``t`` of its stream's gathered view
# (page ``t // page_size``, offset ``t % page_size``), so masks reduce to
# plain position comparisons and batched serving is independent of which
# physical pages a stream happened to get.
#
# ``kv_dtype='int8'`` stores codes + per-(token, head) scales from
# ``kernels.kvattn.quantize_kv`` and decodes single-token steps through
# ``kernels.kvattn.attend_int8_paged`` (on the card, the ``kv_decode``
# kernel's paged entry, which reads the pool through the block tables);
# float dtypes are the reference mode. Scales are stored float16, as in the
# JAX package: the resident-bytes win is the point of int8 KV.

PAGED_KV_DTYPES = ("int8", "float16", "bfloat16", "float32")
_POOL_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32}


def init_paged_kv(num_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, kv_dtype: str = "int8", device=None) -> Params:
    """One attention layer's share of the paged KV pool, zeroed on
    ``device``. int8 pools carry float16 ``k_scale``/``v_scale`` pages
    beside the code pages; float pools are just typed pages. Page 0 is the
    engine's write sink and is never handed to a stream."""
    if kv_dtype not in PAGED_KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {PAGED_KV_DTYPES}")
    shape = (num_pages, page_size, n_kv_heads, head_dim)
    if kv_dtype == "int8":
        return {
            "k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float16, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float16, device=device),
        }
    dt = _POOL_DTYPES[kv_dtype]
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def is_paged(cache: Params) -> bool:
    """A paged-pool cache node, as opposed to the dense ``{k, v, pos}``
    ring buffer."""
    return isinstance(cache, dict) and "k_pages" in cache


def _page_rows(block_tables: torch.Tensor, positions: torch.Tensor,
               page_size: int) -> torch.Tensor:
    """Flat pool-row index for each (stream, position). Writes with no
    real page (unallocated block-table entries (-1), positions past the
    table's capacity) land on page 0, the engine's write sink."""
    mp = block_tables.shape[1]
    pidx = positions // page_size
    page_ids = torch.gather(block_tables, 1, pidx.clamp(0, mp - 1).long())
    page_ids = torch.where(pidx < mp, page_ids, -1)
    return page_ids.clamp_min(0) * page_size + positions % page_size


def _flat(pool: torch.Tensor) -> torch.Tensor:
    """(num_pages, page_size, ...) pool as (rows, ...): a view, so writes
    through it land in the pool."""
    return pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])


def paged_append(cache: Params, k: torch.Tensor, v: torch.Tensor,
                 block_tables: torch.Tensor, positions: torch.Tensor,
                 page_size: int) -> Params:
    """Write C new tokens' K/V into the page pool, in place.

    k, v: (B, C, K, hd) float; block_tables (B, max_pages) int32 (-1 =
    unallocated); positions (B, C) absolute token positions. int8 pools
    quantize through ``quantize_kv`` (f32 scales, stored float16).
    Distinct streams own distinct pages; every inactive-slot write lands
    on page 0, where the winner of duplicate writes is undefined and never
    read (``paged_view`` masks page 0). Returns ``cache``.
    """
    B, C = positions.shape
    rows = _page_rows(block_tables, positions, page_size).reshape(-1).long()

    def scat(pool, vals):
        _flat(pool)[rows] = vals.reshape(B * C, *vals.shape[2:]).to(pool.dtype)

    if "k_scale" in cache:
        from ..kernels.kvattn.ops import quantize_kv

        k8, v8, ks, vs = quantize_kv(k, v)
        for name, vals in (("k_pages", k8), ("v_pages", v8),
                           ("k_scale", ks), ("v_scale", vs)):
            scat(cache[name], vals)
    else:
        scat(cache["k_pages"], k)
        scat(cache["v_pages"], v)
    return cache


def paged_attend(q: torch.Tensor, cache: Params, block_tables: torch.Tensor,
                 positions: torch.Tensor, page_size: int, *,
                 window: Optional[int] = None,
                 backend: str = "auto") -> torch.Tensor:
    """Attention over a paged KV cache: the read half of the handle.

    q: (B, C, H, hd); positions (B, C) absolute positions of the query
    tokens (already appended). Single-token int8 decode goes through
    ``attend_int8_paged`` before any gather (``backend`` picks the kernel,
    which reads the pool through the block tables, or the plain version
    over the gathered view); chunked-prefill reads (C > 1) and float pools
    dequantize the gathered view and share :func:`decode_attend`.
    """
    if "k_scale" in cache and q.shape[1] == 1:
        from ..kernels.kvattn.ops import attend_int8_paged

        out = attend_int8_paged(q[:, 0].contiguous(), cache, block_tables,
                                positions[:, 0].contiguous(), page_size,
                                window=window, backend=backend)
        return out[:, None]
    gather, kpos = paged_view(cache, block_tables, page_size)
    if "k_scale" in cache:
        k8, v8 = gather(cache["k_pages"]), gather(cache["v_pages"])
        ks = gather(cache["k_scale"]).to(torch.float32)
        vs = gather(cache["v_scale"]).to(torch.float32)
        k = (k8.to(torch.float32) * ks[..., None]).to(q.dtype)
        v = (v8.to(torch.float32) * vs[..., None]).to(q.dtype)
        return decode_attend(q, k, v, kpos, positions, window=window)
    k = gather(cache["k_pages"]).to(q.dtype)
    v = gather(cache["v_pages"]).to(q.dtype)
    return decode_attend(q, k, v, kpos, positions, window=window)
