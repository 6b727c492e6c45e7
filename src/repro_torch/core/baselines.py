"""PTQ baselines the paper compares against (Tables 2-4).

The port of the JAX package's ``repro.core.baselines``:

* RTN            — round-to-nearest with minmax or MSE ("OMSE") scales.
* Bias correction (Nagel et al. 2019) — RTN + per-layer expected-output
                   correction folded into a bias term.
* AdaQuant       (Hubara et al. 2020) — per-layer continuous weight
                   perturbation optimized through an STE quantizer.
* LAPQ           (Nahshan et al. 2019) — loss-aware per-layer clip-scale
                   search on the task loss (coordinate descent flavour).

All share the Walker/QuantHook machinery so accuracy comparisons are
apples-to-apples with BRECQ. Everything runs where the params are; the
calibration batches are moved there. No baseline reaches a kernel:
``quantize_dequant`` and ``fake_quant_ste`` are plain PyTorch, as their
JAX counterparts are plain ``jnp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..interop import tree_leaves
from ..models.common import NO_QUANT, QuantHook
from ..optim import adam
from . import lsq
from .hooks import RecordingHook, RTNHook
from .quantizer import QState, fake_quant_ste, quantize_dequant
from .reconstruction import (ReconConfig, Walker, _apply_unit, _cap,
                             _concat_batches, _slice_batch, bake,
                             enumerate_weights, init_states)


def _calib_on(params, calib_batches: list[dict]) -> dict:
    """The calibration batches, concatenated on the params' device."""
    device = tree_leaves(params)[0].device
    return _concat_batches([{k: v.to(device) for k, v in b.items()}
                            for b in calib_batches])


def _first(calib: dict, n: int = 1) -> dict:
    return _slice_batch(calib, slice(0, min(n, calib["tokens"].shape[0])))


# ---------------------------------------------------------------------------
# RTN
# ---------------------------------------------------------------------------


@torch.no_grad()
def quantize_rtn(model, params, calib_batches, w_bits: int,
                 a_bits: Optional[int] = None, scale_method: str = "mse",
                 w_group: Optional[int] = None,
                 keep_embed_head_8bit: bool = True):
    """Round-to-nearest PTQ baseline (no reconstruction).

    Args:
      model: block-graph model (same API as ``quantize``).
      params: FP parameters (never mutated).
      calib_batches: calibration batches; only used for weight
        enumeration and (when ``a_bits`` is set) minmax activation scales.
      w_bits: weight bit-width for block weights.
      a_bits: activation bit-width; ``None`` means weight-only.
      scale_method: ``'minmax'`` or ``'mse'`` (the paper's OMSE search).
      w_group: optional per-group weight quantization (rows per group
        along the reduction axis); ``None`` keeps per-channel scales.
      keep_embed_head_8bit: keep embedding/head at 8 bits.

    Returns:
      ``(params_q, act_scales)`` — a params copy with round-to-nearest
      weights baked in, and path -> activation scale (a 0-dim tensor;
      empty when ``a_bits`` is None). Feed both to ``evaluate``.
    """
    rc = ReconConfig(w_bits=w_bits, a_bits=a_bits, scale_method=scale_method,
                     w_group=w_group, keep_embed_head_8bit=keep_embed_head_8bit)
    calib = _calib_on(params, calib_batches)
    weights = enumerate_weights(model, params, _first(calib))
    qstates, embed_head = init_states(model, weights, rc)
    params_q = bake(model, params, qstates, {}, embed_head)
    act_scales = {}
    if a_bits is not None:
        act_scales = _calibrate_act_scales(model, Walker(model), params_q, calib, a_bits)
    return params_q, act_scales


class _AllCap(QuantHook):
    """Per path, the largest minmax LSQ step size of its inputs."""

    def __init__(self, a_bits: int):
        self.a_bits = a_bits
        self.scales: dict[str, torch.Tensor] = {}

    def act(self, path, x):
        s = lsq.init_act_scale(x, self.a_bits, symmetric=True)
        prev = self.scales.get(path)
        self.scales[path] = s if prev is None else torch.maximum(prev, s)
        return x


@torch.no_grad()
def _calibrate_act_scales(model, walker, params_q, calib, a_bits: int) -> dict:
    """Minmax activation scales captured on the quantized model, over the
    first ``min(8, N)`` calibration sequences."""
    cap = _AllCap(a_bits)
    walker.run(params_q, _first(calib, 8), cap)
    return cap.scales


# ---------------------------------------------------------------------------
# Bias correction
# ---------------------------------------------------------------------------


@torch.no_grad()
def quantize_bias_correction(model, params, calib_batches, w_bits: int,
                             scale_method: str = "minmax"):
    """RTN + expected-output correction: b += E[x](W - W_q), per layer.

    Matches Nagel et al. 2019 (no data-free BN trick here; we have real
    calibration activations). ``E[x]`` is the mean input of the layer on
    the quantized stream; that stream advances through each block's
    RTN weights without the corrections already found. Only 2-D linears
    are corrected; stacked MoE expert weights stay RTN. A linear without
    a bias gets a zero ``(n_layers, N)`` one.
    """
    rc = ReconConfig(w_bits=w_bits, scale_method=scale_method)
    calib = _calib_on(params, calib_batches)
    weights = enumerate_weights(model, params, _first(calib))
    qstates, embed_head = init_states(model, weights, rc)
    walker = Walker(model)

    x_q, _ = walker.stem(params, calib, RTNHook(embed_head))
    mem_q = None
    corrections: dict[str, torch.Tensor] = {}
    for bi in range(len(walker.blocks())):
        hook = _BiasCorrHook(qstates)
        x_q = _apply_unit(walker, params, [bi], hook, x_q, calib, mem_q)
        corrections.update(hook.new_corr)
        if walker.encdec and bi == walker.enc_n - 1:
            mem_q, x_q = walker.boundary_transition(params, calib, x_q, RTNHook(embed_head))

    params_q = bake(model, params, qstates, {}, embed_head)
    return _install_biases(params_q, corrections), {}


class _BiasCorrHook(QuantHook):
    """Quantizes weights RTN and records E[x](W - Wq) for 2-D linears.

    A linear hands its hook the weight, then its input (``dense``), so the
    weight's error waits in ``_pending`` until ``act`` brings the input.
    The JAX package's hook takes the correction in ``weight``, before any
    input has arrived, and so installs none (ROADMAP §3.9)."""

    def __init__(self, qstates):
        self.qstates = qstates
        self.new_corr: dict[str, torch.Tensor] = {}
        self._pending: dict[str, torch.Tensor] = {}

    def weight(self, path, w):
        if path not in self.qstates:
            return w
        st, cfg = self.qstates[path]
        wq = quantize_dequant(w, st, cfg)
        if w.ndim == 2:
            self._pending[path] = (w - wq).to(torch.float32)
        return wq

    def act(self, path, x):
        err = self._pending.pop(path, None)
        if err is not None:
            xm = torch.mean(x.reshape(-1, x.shape[-1]).to(torch.float32), dim=0)
            self.new_corr[path] = xm @ err
        return x


def _stacked_node(params_q, path: str):
    """(the param node of a stacked block path, its layer index)."""
    parts = path.split("/")
    sname, ri = parts[0].rsplit(".", 1)
    node = params_q[sname]
    for k in parts[1:]:
        node = node[k]
    return node, int(ri)


def _install_biases(params_q, corrections: dict[str, torch.Tensor]):
    """Add each correction to its layer's row of the linear's bias (a copy:
    the leaves of ``params`` are never written)."""
    fresh: set = set()
    for path, corr in corrections.items():
        if "." not in path.split("/")[0]:
            continue  # embed/head: skip
        node, ri = _stacked_node(params_q, path)
        if "b" not in node:
            node["b"] = torch.zeros((node["w"].shape[0], corr.shape[-1]),
                                    dtype=torch.float32, device=corr.device)
            fresh.add(id(node["b"]))
        elif id(node["b"]) not in fresh:
            node["b"] = node["b"].clone()
            fresh.add(id(node["b"]))
        node["b"][ri] += corr.to(node["b"].dtype)
    return params_q


# ---------------------------------------------------------------------------
# AdaQuant
# ---------------------------------------------------------------------------


def quantize_adaquant(model, params, calib_batches, w_bits: int,
                      a_bits: Optional[int] = None, iters: int = 400,
                      calib_bs: int = 8, lr: float = 1e-3, seed: int = 0):
    """Per-layer continuous weight perturbation through an STE quantizer.

    Layer by layer, ``dw`` minimises ``mean((x @ q(W + dw) - x_fp @ W)^2)``
    with Adam: ``x`` is the layer's input on the quantized stream (LSQ at
    its minmax step when ``a_bits`` is set), ``x_fp`` its input on the FP
    stream. Minibatches come from one ``np.random.default_rng(seed)``
    shared by every layer, in the JAX package's order, so a run replays
    there draw for draw."""
    rc = ReconConfig(w_bits=w_bits, a_bits=a_bits, scale_method="mse")
    calib = _calib_on(params, calib_batches)
    N = calib["tokens"].shape[0]
    b1 = _first(calib)
    weights = enumerate_weights(model, params, b1)
    qstates, embed_head = init_states(model, weights, rc)
    walker = Walker(model)
    rng = np.random.default_rng(seed)
    acfg = adam.AdamConfig(lr=lr)
    rc_fp = dataclasses.replace(rc, a_bits=None)

    with torch.no_grad():
        x_fp, _ = walker.stem(params, calib)
        x_q, _ = walker.stem(params, calib, RTNHook(embed_head))
    mem_fp = mem_q = None
    deltas: dict[str, torch.Tensor] = {}
    s_done: dict[str, torch.Tensor] = {}

    for bi in range(len(walker.blocks())):
        with torch.no_grad():
            rec = RecordingHook()
            _apply_unit(walker, params, [bi], rec, x_q[:1], b1,
                        None if mem_q is None else mem_q[:1])
            wpaths = [p for p in rec.weights if p in qstates]
            z_fp = _apply_unit(walker, params, [bi], NO_QUANT, x_fp, calib, mem_fp)
        for path in wpaths:
            W = weights[path]
            st, qc = qstates[path]
            with torch.no_grad():
                xin_q = _cap_adaquant(walker, params, bi, qstates, deltas, s_done,
                                      a_bits, path, x_q, calib, mem_q)
                xin_fp = _cap(walker, params, bi, qstates, {}, {}, rc_fp, path,
                              x_fp, calib, mem_fp)
                zt = torch.matmul(xin_fp, W.to(xin_fp.dtype))
                if a_bits is not None:
                    s_done[path] = lsq.init_act_scale(xin_q, a_bits, symmetric=True)
                    # the step is fixed while dw trains: quantize the inputs once
                    xin_q = lsq.lsq_quant(xin_q, s_done[path], a_bits, True)
            dw = torch.zeros_like(W)
            ostate = adam.init({"dw": dw})
            for _ in range(iters):
                idx = torch.from_numpy(
                    rng.choice(N, size=min(calib_bs, N), replace=False)).to(W.device)
                dw.requires_grad_(True)
                x = xin_q[idx]
                z = torch.matmul(x, fake_quant_ste(W + dw, st, qc).to(x.dtype))
                loss = torch.mean((z - zt[idx]).to(torch.float32) ** 2)
                (g,) = torch.autograd.grad(loss, dw)
                with torch.no_grad():
                    opt, ostate = adam.update(acfg, {"dw": g}, ostate, {"dw": dw.detach()})
                dw = opt["dw"]
            deltas[path] = dw
        with torch.no_grad():
            x_q = _apply_unit(walker, params, [bi],
                              _AdaQuantHook(qstates, deltas, s_done, a_bits),
                              x_q, calib, mem_q)
            x_fp = z_fp
            if walker.encdec and bi == walker.enc_n - 1:
                mem_fp, x_fp = walker.boundary_transition(params, calib, x_fp)
                mem_q, x_q = walker.boundary_transition(params, calib, x_q,
                                                        RTNHook(embed_head))

    # bake: w -> qdq(w + dw)
    adj = {p: (qstates[p], deltas[p]) for p in deltas}
    params_q = bake(model, params,
                    {p: qstates[p] for p in qstates if p not in deltas}, {}, embed_head)
    params_q = _bake_deltas(model, params_q, adj)
    return params_q, dict(s_done)


class _AdaQuantHook(QuantHook):
    """Weights with a trained ``dw`` at ``qdq(w + dw)``; LSQ inputs on the
    scales found so far."""

    def __init__(self, qstates, deltas, s_done, a_bits):
        self.qstates = qstates
        self.deltas = deltas
        self.s_done = s_done
        self.a_bits = a_bits

    def weight(self, path, w):
        if path in self.deltas:
            st, cfg = self.qstates[path]
            return quantize_dequant(w + self.deltas[path], st, cfg)
        return w

    def act(self, path, x):
        if self.a_bits is not None and path in self.s_done:
            return lsq.lsq_quant(x, self.s_done[path], self.a_bits, True)
        return x


class _AdaQuantCapture(_AdaQuantHook):
    """:class:`_AdaQuantHook` that also keeps the input of ``target``."""

    def __init__(self, qstates, deltas, s_done, a_bits, target: str):
        super().__init__(qstates, deltas, s_done, a_bits)
        self.target = target
        self.captured: Optional[torch.Tensor] = None

    def act(self, path, x):
        x = super().act(path, x)
        if path == self.target:
            self.captured = x
        return x


def _cap_adaquant(walker, params, bi, qstates, deltas, s_done, a_bits, path, x,
                  calib, mem):
    hook = _AdaQuantCapture(qstates, deltas, s_done, a_bits, path)
    _apply_unit(walker, params, [bi], hook, x, calib, mem)
    return hook.captured


@torch.no_grad()
def _bake_deltas(model, params_q, adj):
    """Write ``qdq(w + dw)`` into each adjusted layer's row (a leaf that
    ``bake`` left shared with ``params`` is cloned first)."""
    fresh: set = set()
    for path, ((st, cfg), dw) in adj.items():
        node, ri = _stacked_node(params_q, path)
        if id(node["w"]) not in fresh:
            node["w"] = node["w"].clone()
            fresh.add(id(node["w"]))
        node["w"][ri] = quantize_dequant(node["w"][ri] + dw, st, cfg)
    return params_q


# ---------------------------------------------------------------------------
# LAPQ-style loss-aware scale search
# ---------------------------------------------------------------------------


@torch.no_grad()
def quantize_lapq(model, params, calib_batches, w_bits: int,
                  a_bits: Optional[int] = None,
                  ratios=(0.5, 0.6, 0.7, 0.8, 0.9, 1.0), rounds: int = 1):
    """Coordinate-descent over per-layer clip ratios minimising task loss.

    Each path in turn tries every ratio of its minmax scale, the others at
    their current choice, on the task loss of the first ``min(8, N)``
    calibration sequences (embed/head at 8 bits throughout); the first
    ratio to reach the minimum is kept."""
    rc = ReconConfig(w_bits=w_bits, a_bits=a_bits, scale_method="minmax")
    calib = _calib_on(params, calib_batches)
    probe = _first(calib, 8)
    weights = enumerate_weights(model, params, _first(calib))
    qstates, embed_head = init_states(model, weights, rc)
    walker = Walker(model)

    paths = list(qstates.keys())
    chosen = {p: 1.0 for p in paths}

    def clipped(ratio_of: dict[str, float]) -> dict:
        return {p: (QState(qstates[p][0].scale * ratio_of[p], qstates[p][0].zero_point),
                    qstates[p][1]) for p in paths}

    def loss_with(ratio_of: dict[str, float]) -> float:
        states = clipped(ratio_of)
        states.update(embed_head)
        return float(walker.loss(params, probe, RTNHook(states)))

    for _ in range(rounds):
        for p in paths:
            best_r, best_l = chosen[p], None
            for r in ratios:
                l = loss_with({**chosen, p: r})
                if best_l is None or l < best_l:
                    best_l, best_r = l, r
            chosen[p] = best_r

    params_q = bake(model, params, clipped(chosen), {}, embed_head)
    act_scales = {}
    if a_bits is not None:
        act_scales = _calibrate_act_scales(model, walker, params_q, calib, a_bits)
    return params_q, act_scales
