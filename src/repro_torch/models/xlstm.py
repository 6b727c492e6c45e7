"""xLSTM blocks (mLSTM matrix memory + sLSTM scalar memory).

The port of the JAX package's ``repro.models.xlstm``, with its
adaptations:

* mLSTM runs in the chunkwise-parallel form: quadratic within a chunk,
  the (C, n, m) state carried from chunk to chunk (a loop over the
  ``S / chunk`` chunks in place of ``lax.scan``).
* sLSTM has no hidden-to-gate recurrence (R = 0), so its forward is two
  associative scans (max-plus for the stabiliser, then a first-order linear
  recurrence, through ``common.associative_scan``); decode is the exact
  recurrent step.
* The decode state is O(1) in the sequence length: a (heads, hd, hd)
  matrix memory per mLSTM block, stored v-major (``C[d, e] = v_d k_e``).

Every step returns its new state; the model writes it into the cache's
views in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import common as cm
from .common import Ctx

_M0 = -1e30  # the stabiliser's start: no history


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    d_model: int
    n_heads: int
    expansion: float = 2.0
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.expansion)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, spec: XLSTMSpec):
    d, di = spec.d_model, spec.d_inner
    return {
        "in_proj": cm.dense_init(gen, d, 2 * di),  # (x branch, z gate branch)
        "wq": cm.dense_init(gen, di, di),
        "wk": cm.dense_init(gen, di, di),
        "wv": cm.dense_init(gen, di, di),
        "w_if": cm.dense_init(gen, di, 2 * spec.n_heads),  # input & forget gate pre-acts
        "out_norm": cm.rmsnorm_init(spec.head_dim, gen.device),
        "out_proj": cm.dense_init(gen, di, d),
    }


def _mlstm_qkvif(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor):
    B, S, _ = x.shape
    H, hd = spec.n_heads, spec.head_dim
    xz = cm.dense(ctx, p, "in_proj", x)
    xi, z = xz.chunk(2, dim=-1)
    q = cm.dense(ctx, p, "wq", xi).reshape(B, S, H, hd)
    k = cm.dense(ctx, p, "wk", xi).reshape(B, S, H, hd) / math.sqrt(hd)
    v = cm.dense(ctx, p, "wv", xi).reshape(B, S, H, hd)
    gif = cm.dense(ctx, p, "w_if", xi).to(torch.float32).reshape(B, S, 2, H)
    return q, k, v, gif[:, :, 0], gif[:, :, 1], z  # gates (B, S, H)


def _chunk_state_init(B: int, H: int, hd: int, device=None):
    return (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),  # C
            torch.zeros((B, H, hd), dtype=torch.float32, device=device),  # n
            torch.full((B, H), _M0, dtype=torch.float32, device=device))  # m


def _mlstm_chunk(carry, inp):
    """One chunk of the chunkwise-parallel mLSTM: (new carry, h (B, L, H,
    hd)). q/k/v (B, L, H, hd), gates (B, L, H)."""
    C, n, m = carry
    q, k, v, ig, fg = (t.to(torch.float32) for t in inp)
    L = q.shape[1]
    lf = cm.log_sigmoid(fg)  # (B, L, H)
    Fc = torch.cumsum(lf, dim=1)  # inclusive cumulative log-forget
    G = Fc[:, -1]  # (B, H) the chunk's total decay
    # intra-chunk pair weights: w_ij = F_i - F_j + i_j (j <= i)
    wij = Fc[:, :, None, :] - Fc[:, None, :, :] + ig[:, None, :, :]  # (B, i, j, H)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    wij = torch.where(causal, wij, -math.inf)
    w_state = Fc + m[:, None, :]  # the state's weight at step i: F_i + m_prev
    m_i = torch.clamp_min(torch.maximum(wij.amax(dim=2), w_state), _M0)  # (B, L, H)
    dmat = torch.exp(wij - m_i[:, :, None, :])  # (B, i, j, H)
    s = torch.einsum("bihd,bjhd->bijh", q, k)
    sv = torch.einsum("bijh,bjhd->bihd", s * dmat, v)
    sn = torch.einsum("bijh,bjhd->bihd", dmat, k)
    w_st = torch.exp(w_state - m_i)  # (B, L, H)
    # C is v-major: C[d, e] = v_d k_e, so q contracts the k index (e)
    inter = torch.einsum("bihe,bhde->bihd", q, C) * w_st[..., None]
    inter_n = n[:, None] * w_st[..., None]  # (B, L, H, hd)
    den = torch.einsum("bihd,bihd->bih", q, sn + inter_n)
    den = torch.maximum(den.abs(), torch.exp(-m_i))
    h = (sv + inter) / den[..., None]
    # the state at the chunk's end
    gj = G[:, None] - Fc + ig  # (B, L, H)
    m_new = torch.maximum(G + m, gj.amax(dim=1))  # (B, H)
    wj = torch.exp(gj - m_new[:, None])
    decay = torch.exp(G + m - m_new)
    C_new = decay[..., None, None] * C + torch.einsum("bjhd,bjhe->bhde", v * wj[..., None], k)
    n_new = decay[..., None] * n + (k * wj[..., None]).sum(dim=1)
    return (C_new, n_new, m_new), h


def mlstm_prefill(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor):
    """The forward over a sequence from the zero state, and the state after
    its last chunk, in one pass (JAX's prefill rebuilds the same state in a
    second pass through the projections and the chunks). S must be a whole
    number of chunks of min(chunk, S), as JAX asserts."""
    B, S, _ = x.shape
    H, hd = spec.n_heads, spec.head_dim
    L = min(spec.chunk, S)
    if S % L:
        raise ValueError(f"mLSTM over S={S} tokens: not a whole number of chunks "
                         f"of {L} (x {tuple(x.shape)}, chunk {spec.chunk})")
    q, k, v, ig, fg, z = _mlstm_qkvif(ctx, p, spec, x)
    carry = _chunk_state_init(B, H, hd, x.device)
    hs = []
    for c in range(S // L):
        part = slice(c * L, (c + 1) * L)
        carry, h = _mlstm_chunk(carry, (q[:, part], k[:, part], v[:, part],
                                        ig[:, part], fg[:, part]))
        hs.append(h)
    h = torch.cat(hs, dim=1).to(x.dtype)
    h = cm.rmsnorm(p["out_norm"], h).reshape(B, S, H * hd)
    h = h * F.silu(z)
    C, n, m = carry
    return cm.dense(ctx, p, "out_proj", h), {"C": C, "n": n, "m": m}


def mlstm_apply(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor) -> torch.Tensor:
    return mlstm_prefill(ctx, p, spec, x)[0]


def mlstm_init_cache(spec: XLSTMSpec, batch: int, device=None):
    C, n, m = _chunk_state_init(batch, spec.n_heads, spec.head_dim, device)
    return {"C": C, "n": n, "m": m}


def mlstm_decode(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor, cache):
    """Exact recurrent step. x: (B, 1, d)."""
    B = x.shape[0]
    H, hd = spec.n_heads, spec.head_dim
    q, k, v, ig, fg, z = _mlstm_qkvif(ctx, p, spec, x)
    q, k, v = (t[:, 0].to(torch.float32) for t in (q, k, v))  # (B, H, hd)
    ig, fg = ig[:, 0], fg[:, 0]  # (B, H)
    lf = cm.log_sigmoid(fg)
    m_new = torch.maximum(lf + cache["m"], ig)
    a = torch.exp(lf + cache["m"] - m_new)
    b = torch.exp(ig - m_new)
    C = a[..., None, None] * cache["C"] + torch.einsum("bhd,bhe->bhde", v * b[..., None], k)
    n = a[..., None] * cache["n"] + k * b[..., None]
    # C[d, e] = v_d k_e: retrieval contracts q with the k index (e)
    num = torch.einsum("bhe,bhde->bhd", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(x.dtype)
    h = cm.rmsnorm(p["out_norm"], h).reshape(B, 1, H * hd)
    h = h * F.silu(z)
    return cm.dense(ctx, p, "out_proj", h), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (R = 0 variant; see module docstring)
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, spec: XLSTMSpec):
    d, di = spec.d_model, spec.d_inner
    return {
        "w_in": cm.dense_init(gen, d, 4 * di),  # z, i~, f~, o pre-acts
        "out_norm": cm.rmsnorm_init(spec.head_dim, gen.device),
        "out_proj": cm.dense_init(gen, di, d),
    }


def _slstm_gates(ctx: Ctx, p, x: torch.Tensor):
    z, ig, fg, og = cm.dense(ctx, p, "w_in", x).chunk(4, dim=-1)
    return (torch.tanh(z).to(torch.float32), ig.to(torch.float32),
            cm.log_sigmoid(fg.to(torch.float32)), torch.sigmoid(og))


def _maxplus(left, right):
    """m -> max(m + a, b), composed: (a_l, b_l) then (a_r, b_r)."""
    al, bl = left
    ar, br = right
    return al + ar, torch.maximum(bl + ar, br)


def _linear(left, right):
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def _slstm_scan(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor):
    """Full-sequence forward from the zero state: (out, every step's c, n
    and m, each (B, S, di))."""
    B, S, _ = x.shape
    di = spec.d_inner
    z, ig, lf, og = _slstm_gates(ctx, p, x)
    # the stabiliser m_t = max(lf_t + m_{t-1}, ig_t): a max-plus scan
    acc_a, acc_b = cm.associative_scan(_maxplus, (lf, ig), 1)
    m0 = torch.full((B, 1, di), _M0, dtype=torch.float32, device=x.device)
    m = torch.maximum(m0 + acc_a, acc_b)  # (B, S, di)
    m_prev = torch.cat([m0, m[:, :-1]], dim=1)
    fa = torch.exp(lf + m_prev - m)
    ib = torch.exp(ig - m)
    _, c = cm.associative_scan(_linear, (fa, ib * z), 1)
    _, n = cm.associative_scan(_linear, (fa, ib), 1)
    h = og * (c / torch.clamp_min(n, 1e-6)).to(x.dtype)
    H, hd = spec.n_heads, spec.head_dim
    h = cm.rmsnorm(p["out_norm"], h.reshape(B, S, H, hd)).reshape(B, S, di)
    return cm.dense(ctx, p, "out_proj", h), c, n, m


def slstm_apply(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor) -> torch.Tensor:
    return _slstm_scan(ctx, p, spec, x)[0]


def slstm_prefill(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor):
    """The forward over a prompt and the state after it: the scans' last
    step (JAX replays the gates through a sequential scan for it; the two
    agree to rounding)."""
    out, c, n, m = _slstm_scan(ctx, p, spec, x)
    return out, {"c": c[:, -1], "n": n[:, -1], "m": m[:, -1]}


def slstm_init_cache(spec: XLSTMSpec, batch: int, device=None):
    return {
        "c": torch.zeros((batch, spec.d_inner), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, spec.d_inner), dtype=torch.float32, device=device),
        "m": torch.full((batch, spec.d_inner), _M0, dtype=torch.float32, device=device),
    }


def slstm_decode(ctx: Ctx, p, spec: XLSTMSpec, x: torch.Tensor, cache):
    B = x.shape[0]
    z, ig, lf, og = (t[:, 0] for t in _slstm_gates(ctx, p, x))
    m_new = torch.maximum(lf + cache["m"], ig)
    fa = torch.exp(lf + cache["m"] - m_new)
    ib = torch.exp(ig - m_new)
    c = fa * cache["c"] + ib * z
    n = fa * cache["n"] + ib
    h = og * (c / torch.clamp_min(n, 1e-6)).to(x.dtype)
    H, hd = spec.n_heads, spec.head_dim
    h = cm.rmsnorm(p["out_norm"], h.reshape(B, H, hd)).reshape(B, 1, spec.d_inner)
    return cm.dense(ctx, p, "out_proj", h), {"c": c, "n": n, "m": m_new}
