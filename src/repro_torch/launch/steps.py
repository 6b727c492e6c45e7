"""Step builders: train / prefill / decode laid out over a mesh by a Plan.

The port of the JAX package's ``repro.launch.steps``. Mixed precision as
in JAX: f32 master params, bf16 compute (the cast sits inside the loss, so
gradients land back in f32).

A :class:`Step` is the counterpart of JAX's ``Lowerable``: the step
function, its arguments as fake tensors (shapes and dtypes, no storage)
and their DTensor placements from the plan. :meth:`Step.shard` lays out
global tensors as the plan says; :meth:`Step.run` runs the step on
DTensors, where DTensor propagates the placements op by op as GSPMD does
in JAX; :meth:`Step.trace` runs it on fake tensors for the dry run.
``act_shard_fn`` and ``cache_shard_fn`` pin activations and the decode
cache with JAX's rules, by ``redistribute``.

The models run their matmuls, attention, expert einsums and embedding
per rank (``local_map`` in ``models/common.py`` and ``moe.py``, Megatron's
rules), so DTensor propagates only the ops between them. Where DTensor has
no strategy for an op on a sharded operand, the model gathers that operand
at that one site and counts it in ``GATHERS`` (site -> gathers): the cross
entropy's gather over vocab-parallel logits (``softmax_xent``), the MoE
routing scatter (``moe.scatter``) and capacity dispatch (``moe.dispatch``,
``moe.combine``), packed codes sharded other than along N (``packed.codes``,
``packed.x``: expert stacks along E), and kv heads that do not divide the
model axis (``heads``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

import torch

from ..configs.base import ShapeSpec
from ..dist.sharding import P, Plan, fake_init, placements
from ..interop import tree_leaves, tree_map
from ..models.common import GATHERS, is_dtensor, local_slice  # noqa: F401
from ..optim import adam
from . import specs as specs_mod

# DTensor warns on every redistribution that takes one collective per mesh
# dim (a dim sharded over two axes); the plan's batch rules ask for that
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)


def cast_float(tree, dtype=torch.bfloat16):
    return tree_map(lambda x: _cast(x, dtype) if x.is_floating_point() else x, tree)


def _cast(x, dtype):
    """``x.to(dtype)``; a DTensor is cast shard by shard (the layout is the
    same, so DTensor has nothing to propagate), autograd running through."""
    if not is_dtensor(x):
        return x.to(dtype)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local().to(dtype), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def _zip(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _zip(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_tree(tree, layout, device_mesh):
    """Global tensors -> DTensors laid out by ``layout`` (a tree of
    placement lists), each rank keeping its own slice: every rank must
    hold the same global tree. No collective runs."""
    from torch.distributed.tensor import DTensor

    def leaf(t, pl):
        shape, off = local_slice(t.shape, device_mesh, pl)
        local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        return DTensor.from_local(local.contiguous(), device_mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return _zip(leaf, tree, layout)


def full_tree(tree):
    """DTensors -> whole tensors (gathered), plain tensors as they are."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of DTensors (or plain tensors)."""
    return sum((t.to_local() if is_dtensor(t) else t).numel() * t.element_size()
               for t in tree_leaves(tree))


@dataclasses.dataclass
class Step:
    """A step function, its fake-tensor args, and the plan's layout of
    them: ``layout(*args) -> (in_placements, out_placements)``, one tree of
    placement lists per arg, and a tree like the outputs (``None`` leaves
    stay as computed)."""

    fn: Callable
    args: tuple  # trees of fake tensors: global shapes and dtypes
    layout: Callable
    plan: Plan
    mode: Any = None  # the FakeTensorMode the args were made in

    def shard(self, *args, device_mesh):
        """Global tensor trees (the same on every rank) -> DTensor trees
        laid out by the plan (from their own shapes: a prompt shorter than
        the planned cache is laid out by the same rules)."""
        return tuple(shard_tree(a, pl, device_mesh)
                     for a, pl in zip(args, self.layout(*args)[0]))

    def run(self, *args):
        """The step on DTensors laid out by :meth:`shard`; the outputs are
        laid out as the plan says."""
        from torch.distributed.tensor.experimental import implicit_replication

        out_pl = self.layout(*args)[1]
        with implicit_replication():
            return _relayout(self.fn(*args), out_pl)

    def fake_args(self, device_mesh) -> tuple:
        """The planned args as fake DTensors on ``device_mesh``."""
        return self.shard(*self.args, device_mesh=device_mesh)

    def trace(self, args: tuple):
        """The step on fake DTensors (:meth:`fake_args`, on the ``fake``
        process group of the dry run): shapes, FLOPs and collectives, no
        storage. Returns the fake outputs."""
        with self.mode:
            return self.run(*args)


def _relayout(out, layout):
    if layout is None:
        return out
    if isinstance(out, dict):
        return {k: _relayout(v, layout.get(k) if isinstance(layout, dict) else layout)
                for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(_relayout(o, lay) for o, lay in zip(out, layout))
    if is_dtensor(out) and isinstance(layout, list):
        return out.redistribute(out.device_mesh, layout)
    return out


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


# ---------------------------------------------------------------------------
# activation layout
# ---------------------------------------------------------------------------


def act_shard_fn(plan: Plan, global_batch: int, seq_len: int = 0):
    """Pin activation layouts, as JAX's rules: (B, S, d) hidden states with
    the batch over the data axes, and the sequence over ``model`` for
    tp/fsdp when it tiles by 128 a shard (sequence parallelism); (B, E, ...)
    MoE dispatch tensors expert-major over ``model`` when the batch does
    not use it. Plain tensors pass through."""
    bspec = plan.batch_spec(global_batch, 3, seq_axis=1, seq_len=0)
    b_axes = plan.batch_axes(global_batch)
    has_model = "model" in plan.mesh.shape
    e_axis = "model" if has_model and "model" not in b_axes else None
    seq_axis = None
    if (plan.seq_parallel and plan.strategy in ("tp", "fsdp") and e_axis == "model"
            and seq_len and seq_len % (plan.mesh.shape["model"] * 128) == 0):
        seq_axis = "model"

    def shard(x, kind: str = "tokens"):
        if not is_dtensor(x):
            return x
        if kind == "expert_major":  # (B, E, ...) MoE routing/dispatch
            spec = P(bspec[0], e_axis, *([None] * (x.ndim - 2)))
        elif x.ndim == 3:
            sa = seq_axis if x.shape[1] == seq_len else None
            spec = P(bspec[0], sa, None)
        else:
            spec = P(bspec[0], *([None] * (x.ndim - 1)))
        return x.redistribute(x.device_mesh, placements(spec, plan.mesh))

    return shard


def cache_shard_fn(plan: Plan, global_batch: int):
    """The decode step's layouts inside attention: the query batch-sharded
    and whole elsewhere; the scores following the cache's slot shards; a
    cache leaf as the plan's cache rule without its layer dim."""
    bspec = plan.batch_spec(global_batch, 2)
    model = plan.mesh.shape.get("model", 1)

    def shard(x, leaf: str):
        if not is_dtensor(x):
            return x
        if leaf == "q":
            spec = P(bspec[0], *([None] * (x.ndim - 1)))
        elif leaf == "scores":
            sa = "model" if model > 1 and x.shape[-1] % model == 0 else None
            spec = P(bspec[0], *([None] * (x.ndim - 2)), sa)
        else:
            spec = plan.cache_spec(("stack", leaf), (1, *x.shape), global_batch)[1:]
        return x.redistribute(x.device_mesh, placements(spec, plan.mesh))

    return shard


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_step(model, plan: Plan, shape: ShapeSpec,
                    acfg: Optional[adam.AdamConfig] = None,
                    remat: str = "none", aux_weight: float = 0.01) -> Step:
    """``(params, opt_state, batch) -> (params, opt_state, {"loss",
    "gnorm"})``: the loss of the bf16-cast params, gradients in f32 laid
    out like the params (DTensor reduces them: an all-reduce over the data
    axes, a reduce-scatter where the params are sharded), then Adam."""
    acfg = acfg or adam.AdamConfig(lr=3e-4, grad_clip=1.0)
    shard = act_shard_fn(plan, shape.global_batch, shape.seq_len)

    def train_step(params, opt_state, batch):
        tree = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(tree)
        loss = model.loss(cast_float(tree), batch, remat=remat,
                          aux_weight=aux_weight, act_shard=shard)
        by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda t: _like(by_leaf[id(t)], t), tree)
        with torch.no_grad():
            params2, opt2, gnorm = _update(acfg, grads, opt_state, params)
        return params2, opt2, {"loss": loss.detach(), "gnorm": gnorm}

    mode = _fake_mode()
    params_sds = fake_init(model.cfg, mode)
    with mode:
        opt_sds = adam.init(params_sds)
    batch_sds = specs_mod.input_specs(model.cfg, shape, mode)
    rep = placements(P(), plan.mesh)

    def layout(params, opt, batch):
        p_pl = plan.params_placements(params)
        o_pl = {"m": plan.params_placements(opt["m"]),
                "v": plan.params_placements(opt["v"]), "count": rep}
        b_pl = (None if batch is None else
                plan.batch_placements(batch, batch["tokens"].shape[0], shard_seq=True))
        return (p_pl, o_pl, b_pl), (p_pl, o_pl, {"loss": rep, "gnorm": rep})

    return Step(fn=train_step, args=(params_sds, opt_sds, batch_sds), layout=layout,
                plan=plan, mode=mode)


def _update(acfg: adam.AdamConfig, grads, opt_state, params):
    """Adam, as ``adam.update``. On DTensors only the global norm (for the
    clip and the metric) is a sharded reduction; the rest is elementwise on
    tensors laid out alike, so it runs on each rank's local shards."""
    gnorm = adam.global_norm(grads)
    if not is_dtensor(gnorm):
        params2, opt2 = adam.update(acfg, grads, opt_state, params)
        return params2, opt2, gnorm
    from torch.distributed.tensor import DTensor

    local = lambda tree: tree_map(lambda t: t.to_local() if is_dtensor(t) else t,  # noqa: E731
                                  tree)
    g = local(grads)
    if acfg.grad_clip is not None:  # adam.update's clip, on the whole norm
        scale = torch.clamp(acfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
        g = tree_map(lambda t: t * scale.to_local(), g)
    p2, o2 = adam.update(dataclasses.replace(acfg, grad_clip=None), g,
                         local(opt_state), local(params))

    def back(new, like):
        return DTensor.from_local(new, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape, stride=like.stride())

    return _zip(back, p2, params), _zip(back, o2, opt_state), gnorm


def _like(g, p):
    """A gradient laid out like its param (Partial sums reduced)."""
    if is_dtensor(g) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# serve: prefill / decode
# ---------------------------------------------------------------------------


def _serve_params(model, quant_bits: Optional[int], group: Optional[int], mode):
    """Fake serving params: bf16, or the packed-int deployment format."""
    params = fake_init(model.cfg, mode)
    with mode:
        if quant_bits is None:
            return cast_float(params)
        from ..deploy.pack import quantize_tree

        return quantize_tree(params, quant_bits, group)


def make_prefill_step(model, plan: Plan, shape: ShapeSpec,
                      quant_bits: Optional[int] = None,
                      group: Optional[int] = None, remat: str = "none") -> Step:
    """``(params, batch, cache) -> (last-token logits, cache)``; the cache
    is filled in place, each rank writing its own shard."""
    shard = act_shard_fn(plan, shape.global_batch, shape.seq_len)

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache, act_shard=shard)

    mode = _fake_mode()
    params_sds = _serve_params(model, quant_bits, group, mode)
    batch_sds = specs_mod.input_specs(model.cfg, shape, mode)
    with mode:
        cache_sds = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)

    def layout(params, batch, cache):
        B = batch["tokens"].shape[0]
        c_pl = plan.cache_placements(cache, B)
        return ((plan.params_placements(params),
                 plan.batch_placements(batch, B, shard_seq=True), c_pl), (None, c_pl))

    return Step(fn=prefill_step, args=(params_sds, batch_sds, cache_sds), layout=layout,
                plan=plan, mode=mode)


def make_decode_step(model, plan: Plan, shape: ShapeSpec,
                     quant_bits: Optional[int] = None,
                     group: Optional[int] = None) -> Step:
    """``(params, tokens, cache, pos) -> (logits, cache)``: one token a row
    against a cache of ``shape.seq_len`` slots, written in place."""
    shard = act_shard_fn(plan, shape.global_batch)
    cshard = cache_shard_fn(plan, shape.global_batch)

    def decode_step(params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos, act_shard=shard,
                                 extras={"cache_shard": cshard})

    mode = _fake_mode()
    params_sds = _serve_params(model, quant_bits, group, mode)
    B = shape.global_batch
    with mode:
        tok_sds = torch.empty((B, 1), dtype=torch.int32)
        pos_sds = torch.empty((B,), dtype=torch.int32)
        cache_sds = model.init_cache(B, shape.seq_len, torch.bfloat16)

    def layout(params, tokens, cache, pos):
        B = tokens.shape[0]
        bspec = plan.batch_spec(B, 2)
        c_pl = plan.cache_placements(cache, B)
        return ((plan.params_placements(params), placements(bspec, plan.mesh), c_pl,
                 placements(P(bspec[0]), plan.mesh)), (None, c_pl))

    return Step(fn=decode_step, args=(params_sds, tok_sds, cache_sds, pos_sds),
                layout=layout, plan=plan, mode=mode)


def make_step(kind: str, model, plan: Plan, shape: ShapeSpec, **kw) -> Step:
    if kind == "train":
        kw.pop("quant_bits", None)
        kw.pop("group", None)
        return make_train_step(model, plan, shape, **kw)
    if kind == "prefill":
        return make_prefill_step(model, plan, shape, **kw)
    if kind == "decode":
        kw.pop("remat", None)
        return make_decode_step(model, plan, shape, **kw)
    raise ValueError(kind)
