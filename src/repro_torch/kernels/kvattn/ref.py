"""Plain PyTorch version of int8-KV decode attention (the kernel's oracle)."""
from __future__ import annotations

import math

import torch

from ..spec import KV_TILE

MASK = -1e30


def paged_view(cache, block_tables: torch.Tensor, page_size: int):
    """Gather a dense per-stream view of the serve engine's page pool: the
    addressing rule the paged kernel entry follows (``kv_decode_paged``).

    Returns ``(gather, kpos)``: ``gather(pool)`` -> (B, S_cap, K, hd) with
    token ``t`` at row ``t``, read from page ``block_tables[b, t //
    page_size]`` (-1 reads page 0; S_cap = max_pages * page_size), and
    ``kpos`` (B, S_cap) int32: the row's token position where the row's
    page is allocated, -1 elsewhere (rows of an allocated page beyond the
    stream's written length are masked by the caller's ``<= cur`` check).
    ``cache`` is unused (the JAX signature's)."""
    B, mp = block_tables.shape
    s_cap = mp * page_size
    offs = torch.arange(page_size, dtype=block_tables.dtype,
                        device=block_tables.device)
    rows = (block_tables.clamp_min(0)[..., None] * page_size + offs)
    rows = rows.reshape(B, s_cap).long()

    def gather(pool):
        return pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])[rows]

    allocated = (block_tables >= 0).repeat_interleave(page_size, dim=1)
    iota = torch.arange(s_cap, dtype=torch.int32, device=block_tables.device)
    kpos = torch.where(allocated, iota[None], -1)
    return gather, kpos


def kv_decode_ref(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                  kscale: torch.Tensor, vscale: torch.Tensor, kpos: torch.Tensor,
                  cur_pos: torch.Tensor, window=None) -> torch.Tensor:
    """q: (B,H,hd); k8/v8: (B,S,K,hd) int8; scales (B,S,K); kpos (B,S);
    cur_pos (B,). GQA via H % K == 0. Returns (B,H,hd)."""
    B, H, hd = q.shape
    K = k8.shape[2]
    rep = H // K
    k = k8.to(torch.float32) * kscale[..., None]
    v = v8.to(torch.float32) * vscale[..., None]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), k) / math.sqrt(hd)
    valid = (kpos >= 0) & (kpos <= cur_pos[:, None])
    if window is not None:
        valid = valid & (cur_pos[:, None] - kpos < window)
    s = torch.where(valid[:, None, :], s, MASK)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)


def _merge(parts):
    """Merge (m, l, acc) partials in their order: m* = max m_i, l = sum l_i
    exp(m_i - m*), acc = sum acc_i exp(m_i - m*)."""
    mstar = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(mstar)
    acc = torch.zeros_like(parts[0][2])
    for m, li, ai in parts:
        w = torch.exp(m - mstar)
        l = l + li * w
        acc = acc + ai * w[..., None]
    return mstar, l, acc


def kv_decode_split_ref(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                        kscale: torch.Tensor, vscale: torch.Tensor,
                        kpos: torch.Tensor, cur_pos: torch.Tensor, window=None, *,
                        plan, tile: int = KV_TILE) -> torch.Tensor:
    """A plain model of the kernel's split of S (``spec.plan_kv_decode``):
    the cache's tiles of ``tile`` slots go to ``plan.split`` blocks in
    contiguous shares (block r takes tiles [r * nt // split, (r + 1) * nt //
    split)), and each block's share to its ``plan.warps`` warps the same way.
    A warp runs the f32 online softmax tile by tile (scores ``(q . codes) *
    kscale / sqrt(hd)``, masked ones -1e30, p scaled by the V scale); a
    block merges its warps that had tiles in warp order, and the blocks merge
    in rank order: m* = max m_i, l = sum l_i exp(m_i - m*), acc = sum acc_i
    exp(m_i - m*); out = acc / max(l, 1e-30). Same arguments as
    :func:`kv_decode_ref`."""
    B, H, hd = q.shape
    S, K = k8.shape[1], k8.shape[2]
    G = H // K
    valid = (kpos >= 0) & (kpos <= cur_pos[:, None])
    if window is not None:
        valid = valid & (cur_pos[:, None] - kpos < window)
    qf = q.to(torch.float32).reshape(B, K, G, hd)
    kc = k8.to(torch.float32).permute(0, 2, 1, 3)  # (B, K, S, hd)
    vc = v8.to(torch.float32).permute(0, 2, 1, 3)
    vs = vscale.permute(0, 2, 1)[:, :, None, :]  # (B, K, 1, S)
    s = (torch.einsum("bkgd,bksd->bkgs", qf, kc) * kscale.permute(0, 2, 1)[:, :, None, :]
         / math.sqrt(hd))
    s = torch.where(valid[:, None, None, :], s, MASK)

    def warp(t0, t1):
        m = torch.full((B, K, G), -math.inf)
        l = torch.zeros((B, K, G))
        acc = torch.zeros((B, K, G, hd))
        for t in range(t0, t1):
            sl = slice(t * tile, min((t + 1) * tile, S))
            m_new = torch.maximum(m, s[..., sl].amax(-1))
            e = torch.exp(s[..., sl] - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + e.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgs,bksd->bkgd", e * vs[..., sl], vc[:, :, sl])
            m = m_new
        return m, l, acc

    def shares(t0, n, parts):
        return [(t0 + i * n // parts, t0 + (i + 1) * n // parts) for i in range(parts)]

    nt = -(-S // tile)
    blocks = []
    for b0, b1 in shares(0, nt, plan.split):
        blocks.append(_merge([warp(w0, w1) for w0, w1 in shares(b0, b1 - b0, plan.warps)
                              if w1 > w0]))
    _, l, acc = _merge(blocks)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)
