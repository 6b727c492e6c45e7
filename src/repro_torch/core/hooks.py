"""Quantization hooks: the glue between models (which only know
``QuantHook``) and the BRECQ machinery (quantizer/adaround/lsq).

The port of the JAX package's ``repro.core.hooks``."""
from __future__ import annotations

from typing import Optional

import torch

from ..models.common import QuantHook
from . import adaround, lsq
from .quantizer import QConfig, QState, quantize_dequant


class RecordingHook(QuantHook):
    """Records every (path, shape) the model touches, in traversal order;
    with ``capture_acts`` also every linear's input activation."""

    def __init__(self, capture_acts: bool = False):
        self.weights: dict[str, tuple] = {}
        self.acts: dict[str, torch.Tensor] = {}
        self.capture_acts = capture_acts

    def weight(self, path: str, w: torch.Tensor) -> torch.Tensor:
        self.weights[path] = tuple(w.shape)
        return w

    def act(self, path: str, x: torch.Tensor) -> torch.Tensor:
        if self.capture_acts:
            self.acts[path] = x
        return x


class RTNHook(QuantHook):
    """Round-to-nearest fake quantization per path (baseline + init)."""

    def __init__(self, states: dict[str, tuple[QState, QConfig]],
                 act_scales: Optional[dict[str, torch.Tensor]] = None,
                 a_bits: Optional[int] = None):
        self.states = states
        self.act_scales = act_scales or {}
        self.a_bits = a_bits

    def weight(self, path: str, w: torch.Tensor) -> torch.Tensor:
        if path in self.states:
            st, cfg = self.states[path]
            return quantize_dequant(w, st, cfg)
        return w

    def act(self, path: str, x: torch.Tensor) -> torch.Tensor:
        if self.a_bits is not None and path in self.act_scales:
            return lsq.lsq_quant(x, self.act_scales[path], self.a_bits, True)
        return x


class AdaRoundHook(QuantHook):
    """Soft (differentiable) or hard AdaRound weights + LSQ activations.

    ``opt`` holds the optimization variables: {'v': {path: tensor}, 's':
    {path: 0-dim tensor}}; autograd differentiates through the hook.
    """

    def __init__(self, states: dict[str, tuple[QState, QConfig]],
                 opt: dict, a_bits: Optional[int] = None, soft: bool = True):
        self.states = states
        self.opt = opt
        self.a_bits = a_bits
        self.soft = soft

    def weight(self, path: str, w: torch.Tensor) -> torch.Tensor:
        if path not in self.states or path not in self.opt["v"]:
            return w
        st, cfg = self.states[path]
        fn = adaround.soft_quant if self.soft else adaround.hard_quant
        return fn(w, self.opt["v"][path], st, cfg)

    def act(self, path: str, x: torch.Tensor) -> torch.Tensor:
        if self.a_bits is None or path not in self.opt.get("s", {}):
            return x
        return lsq.lsq_quant(x, self.opt["s"][path], self.a_bits, True)


class LayerCaptureHook(QuantHook):
    """Layer-wise reconstruction hook: hard-quantizes already-finished
    paths (``v_done``) and captures the input activation of one
    ``target`` linear. Path keys may be real (``body.3/sub0/attn/wq``) or
    canonical (``u0/sub0/attn/wq``): the hook only matches strings."""

    def __init__(self, qstates, v_done: dict, target: Optional[str],
                 act_scales: Optional[dict] = None, a_bits: Optional[int] = None):
        self.qstates = qstates
        self.v_done = v_done
        self.target = target
        self.captured: Optional[torch.Tensor] = None
        self.act_scales = act_scales or {}
        self.a_bits = a_bits

    def weight(self, path, w):
        if path in self.v_done:
            st, cfg = self.qstates[path]
            return adaround.hard_quant(w, self.v_done[path], st, cfg)
        return w

    def act(self, path, x):
        if self.a_bits is not None and path in self.act_scales:
            x = lsq.lsq_quant(x, self.act_scales[path], self.a_bits, True)
        if path == self.target:
            self.captured = x
        return x


class ServeHook(QuantHook):
    """Post-calibration serving hook: weights are already baked into the
    params (or packed); only activation fake-quant remains."""

    def __init__(self, act_scales: dict[str, torch.Tensor], a_bits: int):
        self.act_scales = act_scales
        self.a_bits = a_bits

    def act(self, path: str, x: torch.Tensor) -> torch.Tensor:
        s = self.act_scales.get(path)
        if s is None:
            return x
        return lsq.lsq_quant(x, s, self.a_bits, True)


class StackedActHook(ServeHook):
    """Activation hook for a stacked forward: ``scales`` holds the current
    block's per-path step sizes, sliced out of the stacked (n, ...) tree."""

    def __init__(self, scales: dict[str, torch.Tensor], a_bits: int):
        super().__init__(scales, a_bits)
        self.scales = scales
