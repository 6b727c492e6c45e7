"""Plain PyTorch reference of BRECQ block reconstruction (the paper's Alg. 1,
weight-only, one block a unit, diagonal-Fisher weighted output MSE,
AdaRound rounding logits trained with Adam).

It judges what a calibration run journaled for its finished units, from
the FP weights and calibration tokens the benchmark made:

* the scales: one per output column of each block weight, from the MSE
  search over the clip ratios below (the embedding table 8-bit, one scale
  per model dimension); the quantized stem is the table rounded to nearest;
* the quantized stream: every finished unit's block run with its weights
  hardened from the run's rounding logits, stored in the stream dtype
  between units; compared with the run's journaled stream (``stream_gap``);
* the first ``steps`` optimisation steps of every finished unit, followed
  from the unit's own start (its Fisher weights from the FP model's
  gradient at the block output, its FP target, the rounding logits that
  reproduce round-to-nearest, the minibatches the unit's generator draws):
  each step's loss is compared with the run's (``loss_gap``).

The minibatch of iteration ``i`` of unit ``u`` is the first ``bs`` entries
of the ``i``-th ``randperm`` of a ``torch.Generator`` on the device seeded
from ``numpy.random.SeedSequence([seed, u])``: the protocol the
configuration states. ``dtype`` is the compute precision: float32 with
TF32 off for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.model import rmsnorm, rope

# The search grid of the MSE scale init: 80 clip ratios from 0.35 to 1.0,
# as float32 (the values of jnp.linspace(0.35, 1.0, 80)).
MSE_RATIOS = (
    0.3499999940395355, 0.35822784900665283, 0.36645567417144775,
    0.37468352913856506, 0.38291141390800476, 0.3911392390727997,
    0.399367094039917, 0.4075949490070343, 0.4158227741718292,
    0.42405062913894653, 0.43227848410606384, 0.44050630927085876,
    0.4487341642379761, 0.4569620192050934, 0.4651898443698883,
    0.4734176993370056, 0.4816455841064453, 0.48987340927124023,
    0.49810126423835754, 0.5063291192054749, 0.5145570039749146,
    0.5227848291397095, 0.5310126543045044, 0.5392405390739441,
    0.547468364238739, 0.5556961894035339, 0.5639240741729736,
    0.5721518993377686, 0.5803797245025635, 0.5886076092720032,
    0.5968354344367981, 0.6050633192062378, 0.6132911443710327,
    0.6215190291404724, 0.6297468543052673, 0.6379746794700623,
    0.646202564239502, 0.6544303894042969, 0.6626582145690918,
    0.6708860993385315, 0.6791139245033264, 0.6873417496681213,
    0.695569634437561, 0.703797459602356, 0.7120253443717957,
    0.7202531695365906, 0.7284809947013855, 0.7367088794708252,
    0.7449367046356201, 0.753164529800415, 0.7613924145698547,
    0.7696202397346497, 0.7778481245040894, 0.7860759496688843,
    0.7943037748336792, 0.8025316596031189, 0.8107595443725586,
    0.8189873695373535, 0.8272151947021484, 0.8354430198669434,
    0.8436709046363831, 0.851898729801178, 0.8601266145706177,
    0.8683544397354126, 0.8765822649002075, 0.8848101496696472,
    0.8930379748344421, 0.9012658596038818, 0.9094936847686768,
    0.9177215099334717, 0.9259493947029114, 0.9341772198677063,
    0.9424050450325012, 0.9506329298019409, 0.9588607549667358,
    0.9670886397361755, 0.9753164649009705, 0.9835442900657654,
    0.9917721748352051, 1.0)
LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))
ZETA, GAMMA = 1.1, -0.1


def mse_scale(w: torch.Tensor, bits: int, reduce: tuple) -> torch.Tensor:
    """Symmetric scale per kept channel: amax / qmax times the clip ratio
    of least squared rounding error (the first on ties)."""
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    amax = w.abs().amax(dim=reduce, keepdim=True)
    s0 = torch.clamp_min(amax / torch.tensor(float(qmax), device=w.device), 1e-8)
    errs = []
    for r in torch.tensor(MSE_RATIOS, dtype=torch.float32, device=w.device):
        s = s0 * r
        q = torch.clamp(torch.round(w / s), qmin, qmax) * s
        errs.append(((q - w) ** 2).sum(dim=reduce, keepdim=True))
    best = torch.argmin(torch.stack(errs), dim=0)
    return s0 * torch.tensor(MSE_RATIOS, dtype=torch.float32, device=w.device)[best]


def rect_sigmoid(v):
    return torch.clamp(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def init_logits(w, s):
    """Rounding logits whose soft rounding reproduces w: h(v) = frac(w/s)."""
    frac = w / s - torch.floor(w / s)
    p = torch.clamp((frac - GAMMA) / (ZETA - GAMMA), 1e-4, 1 - 1e-4)
    return torch.log(p / (1 - p))


def soft_weight(w, v, s, bits):
    q = torch.clamp(torch.floor(w / s) + rect_sigmoid(v), -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    return q * s


def hard_weight(w, v, s, bits):
    q = torch.clamp(torch.floor(w / s) + (v >= 0).to(w.dtype),
                    -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    return q * s


def beta_at(it: int, total: int, hi=20.0, lo=2.0, warmup=0.2) -> tuple[float, float]:
    f = np.float32
    t = (f(it) / f(total) - f(warmup)) / f(1.0 - warmup)
    t = min(max(t, f(0.0)), f(1.0))
    return float(f(hi) + f(lo - hi) * t), float(f(f(it) >= f(warmup * total)))


class Block:
    """One pre-norm decoder layer with given (possibly quantized) weights."""

    def __init__(self, cfg: dict, lay: dict, dtype):
        self.cfg, self.lay, self.dtype = cfg, lay, dtype
        self.H, self.K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or cfg["hidden_size"] // self.H

    def __call__(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d); ``w`` maps each linear name to its weight."""
        B, S, d = x.shape
        dt = self.dtype
        x = x.to(dt)
        eps, theta = self.cfg["rms_norm_eps"], self.cfg["rope_theta"]
        pos = torch.arange(S, device=x.device)
        h = rmsnorm(x, self.lay["norm1"], eps)
        q = (h @ w["wq"].to(dt)).view(B * S, self.H, self.hd)
        k = (h @ w["wk"].to(dt)).view(B * S, self.K, self.hd)
        v = (h @ w["wv"].to(dt)).view(B, S, self.K, self.hd)
        posb = pos.repeat(B)
        q = rope(q, posb, theta).view(B, S, self.H, self.hd)
        k = rope(k, posb, theta).view(B, S, self.K, self.hd)
        rep = self.H // self.K
        k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(self.hd)
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), -1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, self.H * self.hd)
        x = x + o @ w["wo"].to(dt)
        h = rmsnorm(x, self.lay["norm2"], eps)
        g, u = h @ w["w_gate"].to(dt), h @ w["w_up"].to(dt)
        return x + (torch.nn.functional.silu(g) * u) @ w["w_down"].to(dt)


class CalibRef:
    """The reference over FP ``params`` (the benchmark's tree) and
    calibration ``tokens`` (N, S), computing in ``dtype``."""

    def __init__(self, params: dict, cfg: dict, mix: dict, tokens: torch.Tensor,
                 dtype=torch.float32):
        self.cfg, self.mix, self.tokens, self.dtype = cfg, mix, tokens, dtype
        self.sdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[mix["stream_dtype"]]
        self.bits = mix["w_bits"]
        body = params["body"]["sub0"]
        self.L = cfg["num_hidden_layers"]
        self.fp = []
        for i in range(self.L):
            lay = {"norm1": body["norm1"]["g"][i], "norm2": body["norm2"]["g"][i]}
            lay.update({n: body[g][n]["w"][i] for g, n in LINEARS})
            self.fp.append(lay)
        self.table = params["embed"]["table"]
        self.final_g = params["final_norm"]["g"]
        self.head = self.table.T if cfg["tie_word_embeddings"] else params["head"]["w"]
        # scales: one per output column of each block weight
        self.scales = [{n: mse_scale(lay[n], self.bits, (0,)) for _g, n in LINEARS}
                       for lay in self.fp]
        t_s = mse_scale(self.table, 8, (0,))
        self.table_q = torch.clamp(torch.round(self.table / t_s), -128, 127) * t_s

    def block(self, i: int) -> Block:
        return Block(self.cfg, self.fp[i], self.dtype)

    def fp_weights(self, i):
        return {n: self.fp[i][n] for _g, n in LINEARS}

    # -- streams ------------------------------------------------------------

    @torch.no_grad()
    def stems(self):
        t = self.tokens.long()
        return self.table[t].to(self.sdt), self.table_q[t].to(self.sdt)

    @torch.no_grad()
    def run_block(self, i: int, x: torch.Tensor, w: dict, rows: int = 8) -> torch.Tensor:
        blk = self.block(i)
        return torch.cat([blk(x[a:a + rows].float(), w).to(self.sdt)
                          for a in range(0, x.shape[0], rows)], 0)

    def hardened(self, i: int, v: dict) -> dict:
        """Block ``i``'s weights hardened from rounding logits ``v`` (name ->
        logits); a weight without logits rounds to nearest."""
        out = {}
        for _g, n in LINEARS:
            w, s = self.fp[i][n], self.scales[i][n]
            vv = v.get(n)
            out[n] = (hard_weight(w, vv, s, self.bits) if vv is not None
                      else torch.clamp(torch.round(w / s), -(2 ** (self.bits - 1)),
                                       2 ** (self.bits - 1) - 1) * s)
        return out

    # -- the diagonal Fisher at a block output --------------------------------

    def fisher(self, i: int, batch: int) -> torch.Tensor:
        """Squared gradient of each calibration batch's mean next-token loss
        w.r.t. block ``i``'s output, in the stream dtype, divided by its mean
        over the calibration set. A batch's sequences have equal lengths, so
        its mean is the mean of its sequences' means: the gradient is taken
        one sequence at a time, over ``batch``."""
        parts, total, count = [], None, 0
        for a in range(self.tokens.shape[0]):
            t = self.tokens[a:a + 1].long()
            with torch.no_grad():
                x = self.table[t]
                for j in range(i + 1):
                    x = self.block(j)(x, self.fp_weights(j)).float()
            x = x.detach().requires_grad_()
            y = x
            for j in range(i + 1, self.L):
                y = self.block(j)(y, self.fp_weights(j)).float()
            h = rmsnorm(y, self.final_g, self.cfg["rms_norm_eps"])
            logits = (h.to(self.dtype) @ self.head.to(self.dtype)).float()
            lp = torch.log_softmax(logits[:, :-1], -1)
            loss = -lp.gather(-1, t[:, 1:, None]).mean() / batch
            (g,) = torch.autograd.grad(loss, x)
            g2 = g.float() ** 2
            parts.append(g2.to(self.sdt))
            s = g2.sum(dtype=torch.float32)
            total = s if total is None else total + s
            count += g2.numel()
            del logits, lp, loss, g, y, h
        g2 = torch.cat(parts, 0)
        mean = torch.clamp_min(total / torch.tensor(float(count), device=g2.device), 1e-20)
        return g2 / mean.to(g2.dtype)

    # -- the first steps of a unit ----------------------------------------------

    def follow(self, i: int, x_q: torch.Tensor, z_fp: torch.Tensor, g2: torch.Tensor,
               seed: int, steps: int, bs: int, lr_scale: float = 1.0) -> list[float]:
        """Losses of the first ``steps`` iterations of unit ``i``."""
        iters, lr, lam = self.mix["iters"], self.mix["lr_v"], self.mix["lam"]
        s_ = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=x_q.device).manual_seed(int(s_) & ((1 << 63) - 1))
        W = self.fp_weights(i)
        S = self.scales[i]
        v = {n: init_logits(W[n], S[n]).float() for n in W}
        m = {n: torch.zeros_like(t) for n, t in v.items()}
        u = {n: torch.zeros_like(t) for n, t in v.items()}
        blk = self.block(i)
        nelem = sum(t.numel() for t in v.values())
        losses = []
        for it in range(steps):
            idx = torch.randperm(x_q.shape[0], generator=gen, device=x_q.device)[:bs]
            vv = {n: t.detach().requires_grad_() for n, t in v.items()}
            with torch.enable_grad():
                w = {n: soft_weight(W[n], vv[n], S[n], self.bits) for n in W}
                x = blk(x_q[idx].float(), w).float()
                err = (x - z_fp[idx].float()) ** 2 * g2[idx].float()
                beta, on = beta_at(it, iters)
                reg = sum(torch.sum(1.0 - torch.abs(2.0 * rect_sigmoid(t) - 1.0) ** beta)
                          for t in vv.values())
                loss = err.mean() + lam * on * reg / nelem
                grads = torch.autograd.grad(loss, list(vv.values()))
            losses.append(float(loss.detach()))
            c = torch.tensor(float(it + 1), device=x_q.device)
            b1c = 1.0 - torch.pow(torch.full_like(c, 0.9), c)
            b2c = 1.0 - torch.pow(torch.full_like(c, 0.999), c)
            rate = lr * torch.tensor(lr_scale, device=x_q.device)
            with torch.no_grad():
                for (n, t), g in zip(vv.items(), grads):
                    m[n] = 0.9 * m[n] + (1 - 0.9) * g
                    u[n] = 0.999 * u[n] + (1 - 0.999) * g * g
                    v[n] = t - rate * (m[n] / b1c) / (torch.sqrt(u[n] / b2c) + 1e-8)
        return losses


def judge(ref: CalibRef, journal: dict, seed: int, steps: int = 3) -> dict:
    """Follow a run's finished units: each one's first ``steps`` losses and
    the quantized stream after the last. ``journal``: ``units`` (per-unit
    stats with ``loss_trace``, ``calib_bs``, ``retries``), ``v`` (weight
    path -> rounding logits), ``x_q`` (the run's stream after the last
    finished unit). Returns the two compared numbers."""
    x_fp, x_q = ref.stems()
    worst_loss = 0.0
    batch = ref.mix["calib_bs"]
    for u in journal["units"]:
        i = u["unit"][0]
        g2 = ref.fisher(i, batch)
        z_fp = ref.run_block(i, x_fp, ref.fp_weights(i))
        lr_scale = 0.5 ** int(u.get("retries", 0))
        got = ref.follow(i, x_q, z_fp, g2, seed, steps, int(u["calib_bs"]), lr_scale)
        want = list(u["loss_trace"][:steps])
        for a, b in zip(want, got):
            worst_loss = max(worst_loss, abs(a - b) / max(abs(b), 1e-30))
        v = {n: journal["v"][f"body.{i}/sub0/{g}/{n}"] for g, n in LINEARS
             if f"body.{i}/sub0/{g}/{n}" in journal["v"]}
        x_q = ref.run_block(i, x_q, ref.hardened(i, v))
        x_fp = z_fp
        del g2
    d = journal["x_q"].float() - x_q.float()
    stream_gap = float(d.norm() / x_q.float().norm().clamp_min(1e-30))
    return {"loss_gap": worst_loss, "stream_gap": stream_gap}
