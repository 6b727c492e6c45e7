"""Diagonal Fisher (squared-gradient) capture at block outputs.

The port of the JAX package's ``repro.core.fisher``. BRECQ Sec. 3.3: the
pre-activation Hessian of each reconstruction unit is approximated by the
diagonal FIM, whose entries are the squared gradients of the task loss
w.r.t. the unit's output, per calibration sample. Gradients come from the
epsilon trick: a zero ``eps`` with ``requires_grad`` is added to a block
output; d(loss)/d(eps) is exactly dL/dz.

Two residency modes (:class:`FisherStream`):

* ``mode='stream'`` (default) — g^2 per block, on demand, one backward
  per (block, batch); each batch's g^2 is cast to ``dtype`` (bf16 by
  default) at once and the normalising mean is reduced in f32. Peak
  residency is one block's ``(N, S, d)`` array whatever the depth.
* ``mode='full'`` — one backward per batch captures every block output
  (one eps per block), keeping ``nb x N x S x d`` f32 resident.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import torch

from ..models.common import softmax_xent


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class FisherStream:
    """Per-block diagonal-Fisher provider with bounded residency.

    Args:
      walker: a ``reconstruction.Walker`` over the FP model.
      params: FP parameters (never mutated).
      calib_batches: list of calibration batches; g^2 is computed batch by
        batch and concatenated along the leading (sample) axis.
      mode: ``'stream'`` (per-block on demand) or ``'full'`` (all blocks
        upfront, f32).
      dtype: storage dtype for streamed g^2 (``'full'`` always keeps f32).

    Attributes:
      wall_s: cumulative seconds spent in Fisher computation.
      peak_bytes: peak residency in bytes — one block's array in
        ``'stream'`` mode, the sum of all blocks in ``'full'`` mode.
    """

    def __init__(self, walker, params, calib_batches: list[dict],
                 mode: str = "stream", dtype=torch.bfloat16):
        if mode not in ("stream", "full"):
            raise ValueError(f"fisher mode must be 'stream' or 'full', got {mode!r}")
        self.walker = walker
        self.params = params
        self.batches = calib_batches
        self.mode = mode
        self.dtype = dtype
        self.wall_s = 0.0
        self.peak_bytes = 0
        self._full: Optional[list[torch.Tensor]] = None
        if mode == "full":
            t0 = time.time()
            self._full = self._compute_full()
            _sync(self._full[0])
            self.peak_bytes = sum(f.numel() * f.element_size() for f in self._full)
            self.wall_s += time.time() - t0

    # -- full (reference) mode ---------------------------------------------

    def _compute_full(self) -> list[torch.Tensor]:
        walker = self.walker
        nb = len(walker.blocks())
        parts: list[list[torch.Tensor]] = [[] for _ in range(nb)]
        for b in self.batches:
            with torch.enable_grad():
                eps = [e.requires_grad_() for e in _zero_eps(walker, self.params, b)]
                grads = torch.autograd.grad(walker.loss(self.params, b, eps=eps), eps)
            for bi, g in enumerate(grads):
                parts[bi].append(g.to(torch.float32) ** 2)
        fisher = [torch.cat(p, 0) for p in parts]
        return [f / torch.clamp_min(torch.mean(f), 1e-20) for f in fisher]

    # -- streamed mode ------------------------------------------------------

    def _g2(self, bi: int, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(g^2 at block ``bi``'s output in the stream dtype, its f32 sum)."""
        walker = self.walker
        eps: list = [None] * len(walker.blocks())
        with torch.enable_grad():
            e0 = _eps_zero_for(walker, self.params, batch, bi).requires_grad_()
            eps[bi] = e0
            (g,) = torch.autograd.grad(walker.loss(self.params, batch, eps=eps), e0)
        g2 = g.to(torch.float32) ** 2
        # f32 reduction for the normalising mean; stream-dtype storage
        return g2.to(self.dtype), torch.sum(g2, dtype=torch.float32)

    def for_block(self, bi: int) -> torch.Tensor:
        """Normalised g^2 at block ``bi``'s output, shape ``(N, S, d)``.

        In ``'stream'`` mode each call recomputes (nothing is retained
        between calls); in ``'full'`` mode it indexes the precomputed list.
        """
        if self._full is not None:
            return self._full[bi]
        t0 = time.time()
        parts, total, count = [], None, 0
        for b in self.batches:
            g2, s = self._g2(bi, b)
            parts.append(g2)
            total = s if total is None else total + s
            count += g2.numel()
        g2 = torch.cat(parts, 0)
        cnt = torch.tensor(float(count), dtype=torch.float32, device=g2.device)
        mean = torch.clamp_min(total / cnt, 1e-20)
        g2 = g2 / mean.to(g2.dtype)
        # sync before timing: the Fisher compute is not booked into the
        # caller's optimization wall time
        _sync(g2)
        self.peak_bytes = max(self.peak_bytes, g2.numel() * g2.element_size())
        self.wall_s += time.time() - t0
        return g2


def _eps_zero_for(walker, params, batch: dict, bi: int) -> torch.Tensor:
    """Zero perturbation with the shape of block ``bi``'s output (a
    decoder block's for an encoder-decoder model past the boundary)."""
    with torch.no_grad():
        x0, _ = walker.stem(params, batch)
    if walker.encdec and bi >= walker.enc_n:
        B, S = batch["tokens"].shape
        return torch.zeros((B, S, x0.shape[-1]), dtype=x0.dtype, device=x0.device)
    return torch.zeros_like(x0)


def _zero_eps(walker, params, batch: dict) -> list[torch.Tensor]:
    """One zero perturbation per block (full-mode eps trick)."""
    with torch.no_grad():
        x, ctx = walker.stem(params, batch)
        eps = []
        for bi in range(len(walker.blocks())):
            eps.append(torch.zeros_like(x))
            x = walker.apply_block(params, bi, x, ctx)
            if walker.encdec and bi == walker.enc_n - 1:
                memory, x = walker.boundary_transition(params, batch, x)
                ctx = walker.ctx_for(batch, bi + 1, memory)
    return eps


def block_grads(model, params, batch: dict) -> list[torch.Tensor]:
    """Per-block output gradients dL/dz_i of the FP model on one batch.

    Returns a list aligned with ``model_blocks(model)``: each entry has
    the block-output shape (B, S, d).
    """
    from .reconstruction import _layer_params

    blocks = model_blocks(model)
    with torch.enable_grad():
        x, ctx = model.begin(params, batch)
        eps = [torch.zeros_like(x, requires_grad=True) for _ in blocks]
        for (stack, ri), e in zip(blocks, eps):
            x, _ = model.apply_block(ctx, stack, _layer_params(params, stack, ri), x)
            x = x + e
        logits = model.finish(params, x, ctx)
        tokens = batch["tokens"]
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:])
        return list(torch.autograd.grad(loss, eps))


def model_blocks(model) -> list[tuple[Any, int]]:
    """Flattened (stack, rel_idx) order of all reconstruction blocks."""
    return [(stack, ri) for stack in brecq_stacks(model) for ri in range(stack.n)]


def brecq_stacks(model):
    """Stacks walked by BRECQ, in forward order (encoder first for enc-dec)."""
    if hasattr(model, "enc_stack"):
        return [model.enc_stack, model.dec_stack]
    return model.stacks
