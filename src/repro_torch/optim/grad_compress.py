"""int8 gradient all-reduce with error feedback (the dp strategy).

The port of the JAX package's ``repro.optim.grad_compress``. The
data-parallel gradient reduction is quantized to int8 codes on a scale all
ranks agree on, and an error-feedback buffer carries each rank's rounding
residual into its next step:

  scale  = max over ranks of max|g + e|, times f32(1/127)   (consensus)
  codes  = round((g + e) / scale), clipped to [-127, 127]
  g_hat  = (sum over ranks of codes) * scale * f32(1/n)
  e_new  = (g + e) - codes * scale                          (local residual)

The arithmetic is the one XLA compiles JAX's ``shard_map`` step to, bit
for bit: the divisions by the constants 127 and n become products with
their f32 reciprocals, and ``e_new`` is one fused multiply-subtract
(computed here in f64, where the product of a code and the scale is
exact, and rounded once to f32).

The collectives are ``torch.distributed.all_reduce``: MAX of one float
per tensor, then SUM of the codes as int32 (the same integers as JAX's f32
sum; every partial sum is at most 127 n). The codes' all-reduce therefore
moves 4 bytes per element, as an f32 all-reduce does: the int8 codes bound
the error, they do not shrink the wire. Where no process group is
initialised the step runs at world 1 and the collectives are identities.

Only the dp strategy: tp/fsdp/zero3 gradients are reduced by DTensor inside
the backward (``launch/steps.py``).
"""
from __future__ import annotations

from typing import Any

import torch

from ..interop import tree_leaves, tree_map
from . import adam

Params = Any

_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _group_size(group) -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed as dist

    if _group_size(group) > 1:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=group)
    return t


def _compress_psum(g: torch.Tensor, e: torch.Tensor, group=None):
    """One tensor's compressed all-reduce: returns (g_hat in g's dtype,
    the new error buffer in f32)."""
    ge = g.to(torch.float32) + e
    n = _group_size(group)
    amax = _all_reduce(torch.max(torch.abs(ge)).reshape(1), "MAX", group)[0]
    scale = torch.clamp_min(amax * torch.tensor(_INV127, dtype=torch.float32), 1e-12)
    codes = torch.clamp(torch.round(ge / scale), -127, 127)
    summed = _all_reduce(codes.to(torch.int32), "SUM", group).to(torch.float32)
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=g.device)
    g_hat = summed * scale * inv_n
    e_new = (ge.to(torch.float64) - codes.to(torch.float64) * scale.to(torch.float64))
    return g_hat.to(g.dtype), e_new.to(torch.float32)


def mean_psum(g: torch.Tensor, e: torch.Tensor, group=None):
    """The uncompressed all-reduce in ``_compress_psum``'s place: the f32
    mean of the ranks' gradients, the error buffer left as it is. The
    baseline the int8 step is held against."""
    s = _all_reduce(g.to(torch.float32).clone(), "SUM", group)
    return (s * torch.tensor(1.0 / _group_size(group), dtype=torch.float32)).to(g.dtype), e


def init_error(params: Params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def wire_bytes(params: Params, n: int) -> dict:
    """Bytes one rank sends per step in a ring all-reduce of ``n`` ranks:
    the int32 codes beside an f32 gradient (2 (n-1)/n of each tensor),
    plus the scale's MAX (one f32 per tensor)."""
    numel = sum(p.numel() for p in tree_leaves(params))
    ring = 2.0 * (n - 1) / n if n > 1 else 0.0
    return {"codes_int32": ring * 4 * numel + ring * 4 * len(tree_leaves(params)),
            "f32": ring * 4 * numel}


def rows_of(batch: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s rows of a global batch split ``n`` ways along dim 0
    (``in_specs=P(axis)``)."""
    def take(t):
        if t.shape[0] % n:
            raise ValueError(f"a global batch of {t.shape[0]} rows does not split "
                             f"over {n} ranks")
        b = t.shape[0] // n
        return t[rank * b:(rank + 1) * b]

    return tree_map(take, batch)


def make_dp_train_step(model, mesh, acfg: adam.AdamConfig, remat: str = "dots",
                       axis: str = "data", group=None, reduce=_compress_psum):
    """The data-parallel train step with the int8 error-feedback
    all-reduce: params, optimizer state and error buffer replicated, the
    **global** batch split along dim 0 over ``axis`` of ``mesh`` (a
    ``MeshSpec`` whose other axes are 1). Returns ``step(params, opt_state,
    err, batch) -> (params, opt_state, err, loss)``, the loss averaged over
    the axis. ``group`` is the process group of the axis (default: the
    world). ``reduce(g, e, group) -> (g_hat, e_new)`` is the gradient
    all-reduce: :func:`mean_psum` makes the uncompressed step."""
    from ..launch.train import loss_and_grads

    others = [s for a, s in mesh.shape.items() if a != axis]
    if any(s > 1 for s in others):
        raise ValueError(f"the int8 all-reduce step is data-parallel only; the mesh "
                         f"{mesh.shape} has other axes above 1")
    n = mesh.shape[axis]
    if _group_size(group) != n:
        raise ValueError(f"the {axis!r} axis has {n} ranks, the process group "
                         f"{_group_size(group)}")

    def step(params, opt_state, err, batch):
        import torch.distributed as dist

        rank = dist.get_rank(group) if n > 1 else 0
        local = rows_of(batch, rank, n)
        loss, grads = loss_and_grads(model, params, local, remat)
        # one leaf after another, in the tree's order on every rank
        out = adam._zip_map(lambda g, e: reduce(g, e, group), grads, err)
        g_hat = adam._zip_map(lambda t: t[0], out)
        err2 = adam._zip_map(lambda t: t[1], out)
        with torch.no_grad():
            params2, opt2 = adam.update(acfg, g_hat, opt_state, params)
        loss = _all_reduce(loss.reshape(1).clone(), "SUM", group)[0] * torch.tensor(
            1.0 / n, dtype=torch.float32)
        return params2, opt2, err2, loss

    return step
