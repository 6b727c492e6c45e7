"""Plain PyTorch reference of a dense decoder served from an RTN artifact.

It follows the published architecture (pre-norm RMSNorm blocks, rotary
embeddings on half-split head dims, grouped-query causal attention, SwiGLU
MLP, final norm, head) and the deployment the cell states: every layer's
linear weights rounded to nearest on a symmetric ``w_bits`` grid with one
scale per output column (``amax * f32(1 / qmax)``, clamped at 1e-8), the
embedding table and the head on an 8-bit grid of the same form (the table
with one scale per model dimension, a tied head that table transposed),
and keys and values stored as int8 with one scale per (token, head) (``amax * f32(1 / 127)``, clamped at
1e-8, kept as float16). It derives all of that again from the FP weights
the benchmark made; it reads nothing the program made, and imports
nothing of it.

Departures from the published description: those the configuration file
states under ``departures`` (the RMSNorm epsilon, :func:`norm_eps`).

``dtype`` is the compute precision: float32 (TF32 off) for the reference,
bfloat16 for the control that stands for the next precision down.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rtn(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric round-to-nearest over the input dim (-2), one scale per
    output column: the dequantized f32 weight."""
    qmax = 2 ** (bits - 1) - 1
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(amax * torch.tensor(np.float32(1.0) / np.float32(qmax),
                                                device=w.device), 1e-8)
    return torch.clamp(torch.round(w / scale), -(qmax + 1), qmax) * scale


def kv_int8(x: torch.Tensor) -> torch.Tensor:
    """(..., hd) f32 -> its int8 codes times their float16 scale, in f32."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax * torch.tensor(np.float32(1.0) / np.float32(127.0),
                                                device=x.device), 1e-8)
    codes = torch.clamp(torch.round(x / scale), -128, 127)
    return codes * scale.to(torch.float16).to(torch.float32)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * g.to(x.dtype)


def norm_eps(cfg: dict) -> float:
    """The RMSNorm epsilon the deployment runs: the configuration's stated
    departure where it has one, else the published value."""
    dep = cfg.get("departures", {}).get("rms_norm_eps")
    return dep["value"] if dep else cfg["rms_norm_eps"]


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd); pos (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


class DenseRef:
    """The served model, built one layer at a time from the FP weights:
    ``top`` maps ``("embed", "table")``, ``("final_norm", "g")`` and, when
    untied, ``("head", "w")`` to their tensors; ``layer(i)`` gives layer
    ``i``'s, keyed ``("sub0", "attn", "wq", "w")``, ``("sub0", "norm1",
    "g")`` and so on. Only the rounded weights are kept."""

    def __init__(self, cfg: dict, w_bits: int, top: dict, layer, kv: str = "int8",
                 dtype=torch.float32):
        self.cfg, self.dtype, self.kv = cfg, dtype, kv
        self.d = cfg["hidden_size"]
        self.H, self.K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.d // self.H
        self.eps = norm_eps(cfg)
        self.theta = cfg["rope_theta"]
        self.L = cfg["num_hidden_layers"]
        self.layers = []
        for i in range(self.L):
            src = layer(i)
            lay = {"norm1": src[("sub0", "norm1", "g")], "norm2": src[("sub0", "norm2", "g")]}
            for grp, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("mlp", ("w_gate", "w_up", "w_down"))):
                for n in names:
                    lay[n] = rtn(src[("sub0", grp, n, "w")], w_bits).to(dtype)
            del src
            self.layers.append(lay)
        self.embed = rtn(top[("embed", "table")], 8).to(dtype)
        # a tied head is the 8-bit table itself, transposed
        self.head = (self.embed.T if cfg["tie_word_embeddings"]
                     else rtn(top[("head", "w")], 8).to(dtype))
        self.final_g = top[("final_norm", "g")]

    def _attend(self, q, k, v, q_chunk: int = 1024):
        """Causal attention, q (S, H, hd), k/v (S, K, hd); scores in f32."""
        S = q.shape[0]
        rep = self.H // self.K
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        out = []
        for a in range(0, S, q_chunk):
            qi = q[a:a + q_chunk]
            s = torch.einsum("qhd,khd->hqk", qi, k[:a + qi.shape[0]]).float() / math.sqrt(self.hd)
            qpos = torch.arange(a, a + qi.shape[0], device=q.device)
            kpos = torch.arange(a + qi.shape[0], device=q.device)
            s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None], float("-inf"))
            p = torch.softmax(s, dim=-1).to(v.dtype)
            out.append(torch.einsum("hqk,khd->qhd", p, v[:a + qi.shape[0]]))
        return torch.cat(out, 0)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """f32 logits (len(at), V) of one sequence ``tokens`` (S,) at the
        positions ``at``."""
        S = tokens.shape[0]
        pos = torch.arange(S, device=tokens.device)
        x = self.embed[tokens.long()]
        for lay in self.layers:
            h = rmsnorm(x, lay["norm1"], self.eps)
            q = (h @ lay["wq"]).view(S, self.H, self.hd)
            k = (h @ lay["wk"]).view(S, self.K, self.hd)
            v = (h @ lay["wv"]).view(S, self.K, self.hd)
            q, k = rope(q, pos, self.theta), rope(k, pos, self.theta)
            if self.kv == "int8":
                k = kv_int8(k.float()).to(self.dtype)
                v = kv_int8(v.float()).to(self.dtype)
            x = x + self._attend(q, k, v).reshape(S, self.H * self.hd) @ lay["wo"]
            h = rmsnorm(x, lay["norm2"], self.eps)
            g, u = h @ lay["w_gate"], h @ lay["w_up"]
            x = x + (torch.nn.functional.silu(g) * u) @ lay["w_down"]
        h = rmsnorm(x[at], self.final_g, self.eps)
        return (h @ self.head).float()


def served_gaps(ref: DenseRef, tokens: torch.Tensor, n_prompt: int,
                served: torch.Tensor) -> torch.Tensor:
    """For each served token: how far its reference logit lies below the
    reference's best at that position. ``tokens`` is the prompt followed
    by the served tokens; the i-th served token was chosen at position
    ``n_prompt - 1 + i``."""
    at = torch.arange(n_prompt - 1, n_prompt - 1 + served.shape[0], device=tokens.device)
    lg = ref.logits(tokens, at)
    return lg.max(-1).values - lg.gather(1, served.long()[:, None])[:, 0]


def control_tokens(low: DenseRef, tokens: torch.Tensor, n_prompt: int,
                   n_served: int) -> torch.Tensor:
    """The control's answer: at each served position of the same prompt and
    tokens, the token that ``low`` (the reference in a lower precision) puts
    first."""
    at = torch.arange(n_prompt - 1, n_prompt - 1 + n_served, device=tokens.device)
    return low.logits(tokens, at).argmax(-1)
