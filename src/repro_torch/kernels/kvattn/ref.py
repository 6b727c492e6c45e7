"""Plain PyTorch version of int8-KV decode attention (the kernel's oracle)."""
from __future__ import annotations

import math

import torch

MASK = -1e30


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
