"""Quantized-model evaluation: perplexity / loss / top-1 next-token accuracy.

The port of the JAX package's ``repro.core.evaluate``: FP, baked and
packed parameters go through the same Walker, on their own device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..interop import tree_leaves
from ..models.common import NO_QUANT
from .hooks import ServeHook
from .reconstruction import Walker


@torch.no_grad()
def evaluate(model, params, batches: list[dict], act_scales: Optional[dict] = None,
             a_bits: Optional[int] = None) -> dict:
    """Evaluate a (possibly quantized) model on next-token prediction.

    Args:
      model: block-graph model (the API ``quantize`` consumes).
      params: FP params, the baked ``PTQResult.params_q``, or a packed
        :class:`repro_torch.deploy.QuantizedArtifact` (its ``act_scales``
        and manifest ``a_bits`` apply; weights run through ``qmm``).
      batches: eval batches with ``tokens`` (B, S); moved to the params'
        device.
      act_scales / a_bits: LSQ step sizes and their bit-width; pass both
        or neither.

    Returns:
      dict with ``loss`` (mean next-token cross-entropy, nats), ``ppl``
      and ``top1``, averaged over ``batches``.
    """
    from ..deploy import QuantizedArtifact

    if isinstance(params, QuantizedArtifact):
        act_scales = act_scales or params.act_scales
        a_bits = a_bits or params.a_bits
        params = params.params
    walker = Walker(model)
    hook = ServeHook(act_scales, a_bits) if (act_scales and a_bits) else NO_QUANT
    device = tree_leaves(params)[0].device

    losses, accs = [], []
    for b in batches:
        b = {k: v.to(device) for k, v in b.items()}
        logits = walker.run(params, b, hook)
        tokens = b["tokens"]
        lg, lb = logits[:, :-1].to(torch.float32), tokens[:, 1:].long()
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, lb[..., None])[..., 0]
        losses.append(float(torch.mean(logz - ll)))
        accs.append(float(torch.mean((torch.argmax(lg, -1) == lb).to(torch.float32))))
    loss = sum(losses) / len(losses)
    return {"loss": loss, "ppl": math.exp(loss), "top1": sum(accs) / len(accs)}
