"""Shared building blocks of the models, in plain PyTorch.

Conventions follow the JAX package's ``repro.models.common``:

* Params are nested dicts of tensors. A linear layer is ``{'w': (in,
  out)}`` (+ optional ``'b'``); weight layout is (reduction_dim,
  output_dim).
* Every matmul goes through :func:`dense`, which consults the quant hook
  ``ctx.quant``. A node with a ``qscale`` sibling holds packed int codes
  and runs through ``QuantHook.packed_matmul`` -> ``qmm``.
* Attention is written out (no fused SDPA): it reproduces the JAX math,
  including the online softmax of :func:`chunked_attention`.
* The paged KV cache of the serve engine (last section) is written in
  place: :func:`paged_append` scatters into the pool tensors it is given.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import sys
from typing import Any, Optional

import torch

from ..kernels.kvattn.ref import paged_view

Params = Any


# ---------------------------------------------------------------------------
# quant hook
# ---------------------------------------------------------------------------


class QuantHook:
    """Interface the models call; the default is a no-op (FP model).

    ``weight(name, w)`` / ``act(name, x)`` return the (possibly
    fake-quantized) weight / activation. When a params node carries
    packed int codes (a ``qscale`` sibling), :func:`dense`/:func:`lm_head`
    hand the whole matmul to ``packed_matmul``, which runs the packed
    ``qmm`` dispatcher. ``packed_backend`` picks its execution path
    (``'auto'``: the CUDA kernels for CUDA tensors, the plain PyTorch
    version for CPU tensors; ``'torch'``; ``'cuda'``).
    """

    packed_backend: str = "auto"

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        return w

    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def packed_matmul(self, name: str, x: torch.Tensor, node: Params,
                      apply_act: bool = True) -> torch.Tensor:
        from ..kernels.qmatmul.ops import from_node, qmm

        if apply_act:
            x = self.act(name, x)
        return qmm(x, from_node(node, x.shape[-1], path=name),
                   backend=self.packed_backend)


NO_QUANT = QuantHook()


# ---------------------------------------------------------------------------
# sharded operands (launch/steps.py runs the models on DTensors)
# ---------------------------------------------------------------------------

# site -> operands gathered there: the places where DTensor has no strategy
# for an op on a sharded operand, so the step gathers it explicitly
GATHERS: collections.Counter = collections.Counter()


def no_shard(x, kind: str = "tokens"):
    """The layout hook of an unsharded run (``act_shard``'s default)."""
    return x


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (none can exist before the module loads)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def unshard(x, site: str, dims: Optional[tuple] = None):
    """``x`` itself, unless it is a DTensor sharded or partial where the op
    at ``site`` cannot take it: then it is gathered over the tensor dims
    ``dims`` (all of them by default) and ``GATHERS[site]`` counts it. The
    result stays a DTensor, so autograd runs through the gather."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = set(range(x.ndim)) if dims is None else {d % x.ndim for d in dims}
    new = [Replicate() if (p.is_partial() or (isinstance(p, Shard) and p.dim in dims))
           else p for p in x.placements]
    if new == list(x.placements):
        return x
    GATHERS[site] += 1
    return x.redistribute(x.device_mesh, new)


def local_slice(shape, mesh, placements) -> tuple[tuple, tuple]:
    """(local shape, global offset) of this rank's shard of a ``shape``
    tensor laid out by ``placements`` on ``mesh``: a dim split over several
    mesh dims is split major first, in mesh order. Every sharded dim must
    divide (the plan's rules guarantee it). Plain arithmetic on the mesh
    coordinate, so it runs under fake tensors too."""
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        n = mesh.size(i)
        if size[p.dim] % n:
            raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways")
        size[p.dim] //= n
        off[p.dim] += coord[i] * size[p.dim]
    return tuple(size), tuple(off)


def replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """A tensor ``t`` made here, as a replicated DTensor on the mesh of
    ``ref`` when ``ref`` is a DTensor (an in-place op on it then takes
    DTensor operands); ``t`` itself otherwise."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def _local_like(t, buf):
    """``t`` (B, C, ...) laid out like the cache leaf ``buf`` (B, S, ...) on
    every dim but the slot dim, which it holds whole: this rank's part
    (gathered, in ``GATHERS["cache.write"]``, where ``t`` comes split or
    partial over a mesh dim that ``buf`` holds whole)."""
    from torch.distributed.tensor import Replicate, Shard

    t = t if is_dtensor(t) else replicated_like(t, buf)
    pl = [p if isinstance(p, Shard) and p.dim != 1 and p.dim < t.ndim else Replicate()
          for p in buf.placements]
    if any(new.is_replicate() and not old.is_replicate()
           for new, old in zip(pl, t.placements)):
        GATHERS["cache.write"] += 1
    return t.redistribute(buf.device_mesh, pl).to_local()


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(*mask.shape, *([1] * (like.ndim - mask.ndim)))


def put_slots(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> None:
    """``buf[b, slot[b, c]] = val[b, c]`` in place, for a cache leaf ``buf``
    (B, S, ...), ``slot`` (B, C) and ``val`` (B, C, ...). On a DTensor
    ``buf`` each rank writes the pairs that land in its own shard of the
    slots, so no cache shard moves; the writes are masked, not selected,
    so the step's shapes never depend on the data."""
    if not is_dtensor(buf):
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, slot] = val.to(buf.dtype)
        return
    shape, off = local_slice(buf.shape, buf.device_mesh, buf.placements)
    out, v = buf.to_local(), _local_like(val, buf).to(buf.dtype)
    rel = _local_like(slot, buf).long() - off[1]  # (b, C)
    n = shape[1]
    if rel.shape[1] == 1:  # one write a row: rows outside write back what is there
        inside = (rel >= 0) & (rel < n)
        rows = torch.arange(rel.shape[0], device=rel.device)[:, None]
        at = rel.clamp(0, n - 1)
        out[rows, at] = torch.where(_bcast(inside, v), v, out[rows, at])
        return
    hit = rel[:, :, None] == torch.arange(n, device=rel.device)  # (b, C, n)
    which = hit.to(torch.int8).argmax(1)  # the write that lands on each slot
    idx = _bcast(which, v).expand(which.shape[0], n, *v.shape[2:])
    out.copy_(torch.where(_bcast(hit.any(1), out), torch.gather(v, 1, idx), out))


def put_prompt(buf: torch.Tensor, val: torch.Tensor, slots: int) -> None:
    """A prompt's S entries (``val`` (B, S, ...), positions 0..S-1) into a
    cache leaf of ``slots`` slots, in place: slots 0..S-1, or, for a ring
    smaller than the prompt, the last ``slots`` positions at ``pos %
    slots``. On a DTensor ``buf`` each rank fills its own slots."""
    S = val.shape[1]
    if not is_dtensor(buf):
        if slots >= S:
            buf[:, :S] = val.to(buf.dtype)
        else:
            idx = torch.arange(S - slots, S, device=val.device) % slots
            buf[:, idx] = val[:, S - slots:].to(buf.dtype)
        return
    shape, off = local_slice(buf.shape, buf.device_mesh, buf.placements)
    out, v = buf.to_local(), _local_like(val, buf).to(buf.dtype)
    lo, hi = off[1], off[1] + shape[1]
    if slots >= S:
        a, b = max(lo, 0), min(hi, S)
        if a < b:
            out[:, a - lo:b - lo] = v[:, a:b]
    else:  # global slot g holds position S - slots + (g - (S - slots)) % slots
        g = torch.arange(lo, hi, device=v.device)
        out.copy_(v[:, S - slots + (g - (S - slots)) % slots])


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and a 2-D w (K, N). On DTensors it runs on
    each rank's shards (``local_map``), mesh dim by mesh dim: a batch or
    sequence shard of ``x`` stays and ``w`` is gathered there (fsdp's
    weight gather); else a column shard of ``w`` (N) gives an N-sharded
    result, and a row shard (K) meets ``x`` sharded along K and gives a
    partial sum (Megatron's column and row parallel matmuls). DTensor's
    own matmul flattens the leading dims, which gathers a batch split over
    two mesh dims."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ref = w if is_dtensor(w) else x
    x = x if is_dtensor(x) else replicated_like(x, ref)
    w = w if is_dtensor(w) else replicated_like(w, ref)
    last = x.ndim - 1
    xp, wp, op, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if isinstance(a, Shard) and a.dim < last:  # rows of x: gather w here
            xp.append(a), wp.append(Replicate()), op.append(a)
            gx.append(a), gw.append(Partial())
        elif isinstance(b, Shard) and b.dim == 1:  # column parallel
            xp.append(Replicate()), wp.append(b), op.append(Shard(last))
            gx.append(Partial()), gw.append(b)
        elif isinstance(b, Shard) and b.dim == 0:  # row parallel
            xp.append(Shard(last)), wp.append(b), op.append(Partial())
            gx.append(Shard(last)), gw.append(b)
        else:
            xp.append(Replicate()), wp.append(Replicate()), op.append(Replicate())
            gx.append(Replicate()), gw.append(Replicate())
    fn = local_map(lambda a, b: a @ b, out_placements=op, in_placements=(xp, wp),
                   in_grad_placements=(gx, gw), device_mesh=ref.device_mesh,
                   redistribute_inputs=True)
    return fn(x, w)


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim). A DTensor split
    along its last dim over more ranks than divide ``heads`` (4 kv heads on
    a model axis of 8) cannot keep that split per head; it is gathered
    there first (``GATHERS["heads"]``)."""
    if is_dtensor(t):
        n = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                      if p.is_shard() and p.dim == t.ndim - 1)
        if heads % n:
            t = unshard(t, "heads", dims=(-1,))
    return t.reshape(*t.shape[:-1], heads, head_dim)


def _whole(t, site: str) -> torch.Tensor:
    """The whole of ``t`` as a plain tensor, gathered (and counted) if it is
    a sharded DTensor."""
    return unshard(t, site).to_local() if is_dtensor(t) else t


def packed_matmul(ctx: "Ctx", path: str, x: torch.Tensor, node: Params,
                  apply_act: bool = True) -> torch.Tensor:
    """``ctx.quant.packed_matmul`` on a packed node, which a sharded step may
    hold as DTensors. Codes sharded along N only (the plan's packed rule):
    each rank runs ``qmm`` on its own columns of the codes and the matching
    columns of the replicated ``qscale``, on ``x`` whole along K (gathered
    there, in ``GATHERS["packed.x_k"]``, when it comes sharded or partial),
    and the result is sharded along N; the codes never move. Any other sharding of
    the codes (expert stacks along E) is gathered, in ``GATHERS``."""
    w = node["w"]
    if not is_dtensor(w):
        return ctx.quant.packed_matmul(path, x, node, apply_act)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = w.device_mesh
    n_dims = [i for i, p in enumerate(w.placements)
              if isinstance(p, Shard) and p.dim == w.ndim - 1]
    xd = x if is_dtensor(x) else replicated_like(x, w)
    if w.ndim != 2 or any(not p.is_replicate() for i, p in enumerate(w.placements)
                          if i not in n_dims):
        whole = {k: _whole(v, "packed.codes") for k, v in node.items() if k != "b"}
        y = ctx.quant.packed_matmul(path, _whole(xd, "packed.x"), whole, apply_act)
        return replicated_like(y, w)
    # x whole along K on every mesh dim; a batch shard elsewhere stays
    xpl = [p if (isinstance(p, Shard) and i not in n_dims and p.dim < xd.ndim - 1)
           else Replicate() for i, p in enumerate(xd.placements)]
    if xpl != list(xd.placements):
        GATHERS["packed.x_k"] += 1
    shape, off = local_slice(w.shape, mesh, w.placements)
    qs = node["qscale"]
    qs = qs.to_local() if is_dtensor(qs) else qs
    local = {"w": w.to_local(),
             "qscale": qs[..., off[-1]:off[-1] + shape[-1]].contiguous()}
    y = ctx.quant.packed_matmul(path, xd.redistribute(mesh, xpl).to_local(), local,
                                apply_act)
    ypl = [Shard(y.ndim - 1) if i in n_dims else xpl[i] for i in range(mesh.ndim)]
    return DTensor.from_local(y, mesh, ypl, run_check=False)


@dataclasses.dataclass
class Ctx:
    """Per-forward context threaded through blocks."""

    cfg: Any
    positions: torch.Tensor  # (B, S) absolute positions of the current tokens
    quant: QuantHook = dataclasses.field(default_factory=lambda: NO_QUANT)
    extras: dict = dataclasses.field(default_factory=dict)
    scope: str = ""  # name scope for quant hook paths

    def scoped(self, name: str) -> "Ctx":
        return dataclasses.replace(self, scope=f"{self.scope}/{name}" if self.scope else name)


# ---------------------------------------------------------------------------
# initialisation helpers (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> Params:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=dtype, device=gen.device)
    return {"w": w.uniform_(-scale, scale, generator=gen)}


def dense(ctx: Ctx, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Quant-aware linear: x @ W. The only matmul entry point."""
    node = p[name]
    path = f"{ctx.scope}/{name}" if ctx.scope else name
    if "qscale" in node:
        y = packed_matmul(ctx, path, x, node)
    else:
        w = ctx.quant.weight(path, node["w"])
        x = ctx.quant.act(path, x)
        y = matmul(x, w.to(x.dtype))
    if "b" in node:
        y = y + node["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance reduced in f32; normalization stays in x.dtype."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["g"].to(x.dtype)


def layernorm_init(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True).to(x.dtype)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu) * inv * p["g"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int) -> Params:
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device)
    return {"table": table * 0.02}


def _rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On a DTensor table each rank looks its tokens up in
    its own rows (``local_map``): a table sharded along the vocabulary
    gives rows of zeros for the tokens outside its shard, and the result is
    a partial sum over those mesh dims (Megatron's vocab-parallel
    embedding; exact, one term of each sum is non-zero). A table sharded
    along d is gathered first."""
    if not (is_dtensor(table) or is_dtensor(tokens)):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ref = table if is_dtensor(table) else tokens
    mesh = ref.device_mesh
    table = table if is_dtensor(table) else replicated_like(table, ref)
    tokens = tokens if is_dtensor(tokens) else replicated_like(tokens, ref)
    t_pl, k_pl, o_pl, g_pl = [], [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        vocab = isinstance(tp, Shard) and tp.dim == 0
        batch = not vocab and isinstance(kp, Shard) and kp.dim == 0
        t_pl.append(Shard(0) if vocab else Replicate())
        k_pl.append(Shard(0) if batch else Replicate())
        o_pl.append(Partial() if vocab else Shard(0) if batch else Replicate())
        # a rank's rows see only its tokens: over a batch shard the table's
        # gradient is a partial sum
        g_pl.append(Shard(0) if vocab else Partial() if batch else Replicate())
    n, off = local_slice(table.shape, mesh, t_pl)

    def look(tab, tok):
        idx = tok.long() - off[0]
        inside = (idx >= 0) & (idx < n[0])
        rows = tab[idx.clamp(0, n[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))

    fn = local_map(look, out_placements=o_pl, in_placements=(t_pl, k_pl),
                   in_grad_placements=(g_pl, k_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, tokens)


def embed_lookup(ctx: Ctx, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    if "table_qscale" in p:  # int8 deployment table: gather, then dequant
        rows = _rows(p["table"], tokens).to(torch.float32)
        return rows * p["table_qscale"][0]
    table = ctx.quant.weight("embed/table", p["table"])
    return _rows(table, tokens)


def lm_head(ctx: Ctx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Output projection to vocab logits; may be tied to the embedding.

    ``p`` is a head node (``{"w": (d, V)}``, possibly packed) or, with
    tied embeddings, the embedding node (``{"table": (V, d)}``, possibly
    int8 with ``table_qscale``). A tied int8 table is dequantized whole
    on every call, as in the JAX package.
    """
    if "qscale" in p:
        return packed_matmul(ctx, "head/w", x, p)
    if "table_qscale" in p:  # tied to an int8 table: (V, d) -> (d, V)
        w = (p["table"].to(torch.float32) * p["table_qscale"][0]).T
    elif "table" in p:  # tied FP table
        w = ctx.quant.weight("head/w", p["table"].T)
        x = ctx.quant.act("head/w", x)
    else:
        w = ctx.quant.weight("head/w", p["w"])  # (d, vocab)
        x = ctx.quant.act("head/w", x)
    return matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# activations with JAX's formulas, and the associative scan
# ---------------------------------------------------------------------------


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0) at every x
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def associative_scan(fn, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(left, right) -> combined`` (tuples of tensors).

    The recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half, then fill in the even positions, so the operands meet in
    JAX's order. It runs about 2 * log2(S) rounds of whole-tensor ops and
    stays differentiable.
    """
    dim %= elems[0].ndim
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    odd = associative_scan(fn, fn(tuple(sl(e, 0, -1, 2) for e in elems),
                                  tuple(sl(e, 1, None, 2) for e in elems)), dim)
    left = odd if n % 2 else tuple(sl(e, 0, -1) for e in odd)
    even = fn(left, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim``; ``a`` may hold one more."""
    nb = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, nb), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == nb:
        return pairs
    return torch.cat([pairs, a.narrow(dim, nb, 1)], dim=dim)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V), labels (B,S)."""
    logits = unshard(logits.to(torch.float32), "softmax_xent", dims=(-1,))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


MASK_VALUE = -1e30


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask. ``window`` enables sliding-window attn."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return m


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain attention. q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) with GQA repeat."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    if K != H:
        rep = H // K
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if mask is not None:
        m = mask[:, None] if mask.ndim == 3 else mask
        scores = torch.where(m, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      iota_pos: bool = False) -> torch.Tensor:
    """Flash-style attention: online softmax over KV chunks, looped over Q
    chunks, in the same chunk order and arithmetic as the JAX version.

    ``iota_pos=True`` asserts positions are plain aranges; with causal
    attention over equal square chunks, KV chunks wholly above the
    diagonal (or outside the window) are skipped, as in the JAX triangle
    unroll. A length that is not a multiple of its chunk ends in a
    shorter chunk (the JAX version asserts whole chunks; Whisper's 1,500
    frames need the remainder); the triangle skip then stays off.
    q: (B,Sq,H,hd) k/v: (B,Sk,K,hd) q_pos: (B,Sq) k_pos: (B,Sk)
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    rep = H // K
    nq, nk = -(-Sq // q_chunk), -(-Sk // kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    triangle = (iota_pos and causal and q_chunk == kv_chunk and Sq == Sk
                and Sq % q_chunk == 0 and nq <= 8)

    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpi = q_pos[:, i * q_chunk:(i + 1) * q_chunk]
        lo, hi = 0, nk
        if triangle:
            hi = i + 1
            if window is not None:
                lo = max(0, (i * q_chunk - (window - 1)) // kv_chunk)
        qn = qi.shape[1]
        m = torch.full((B, H, qn), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, qn), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qn, hd), dtype=torch.float32, device=q.device)
        for j in range(lo, hi):
            ki = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vi = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            kpi = k_pos[:, j * kv_chunk:(j + 1) * kv_chunk]
            if rep != 1:
                ki = ki.repeat_interleave(rep, dim=2)
                vi = vi.repeat_interleave(rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki).to(torch.float32) * scale
            if causal or window is not None:
                delta = qpi[:, None, :, None] - kpi[:, None, None, :]
                mask = delta >= 0 if causal else torch.ones_like(delta, dtype=torch.bool)
                if window is not None:
                    mask = mask & (delta < window)
                s = torch.where(mask, s, MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vi.dtype), vi).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))  # (B, qc, H, hd)
    return torch.cat(outs, dim=1)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`chunked_attention`; on a DTensor ``q`` it runs on each rank's
    own rows and heads (``local_map``), since attention never mixes batch
    rows or heads. A batch shard of ``q`` stays; a head shard stays where
    both H and the kv heads K divide it (so the GQA groups stay whole);
    everything else is gathered first."""
    if not is_dtensor(q):
        return chunked_attention(q, k, v, q_pos, k_pos, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    heads = 1
    qkv, pos = [], []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            qkv.append(Shard(0))
            pos.append(Shard(0))
            continue
        if isinstance(p, Shard) and p.dim == 2 and H % (heads * n) == 0 \
                and K % (heads * n) == 0:
            heads *= n
            qkv.append(Shard(2))
        else:
            qkv.append(Replicate())
        pos.append(Replicate())
    args = [t if is_dtensor(t) else replicated_like(t, q) for t in (q, k, v, q_pos, k_pos)]
    fn = local_map(lambda *a: chunked_attention(*a, **kw), out_placements=qkv,
                   in_placements=(qkv, qkv, qkv, pos, pos), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*args)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  k_pos: torch.Tensor, cur_pos: torch.Tensor, *,
                  window: Optional[int] = None, shard=None) -> torch.Tensor:
    """Decode attention against a cache for one or a few query tokens.

    GQA-native (no head repeat of the cache). q: (B,C,H,hd); caches
    (B,S,K,hd); k_pos (B,S) absolute positions of cache slots (-1 for
    empty); cur_pos (B,C) current position of each query token. ``shard``
    (a sharded step's ``cache_shard``) lays out the scores.
    """
    B, C, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, C, K, G, hd)
    s = torch.einsum("bckgd,bskd->bckgs", qg, k_cache).to(torch.float32)
    s = s / math.sqrt(hd)
    valid = (k_pos[:, None] >= 0) & (k_pos[:, None] <= cur_pos[..., None])
    if window is not None:
        valid = valid & (cur_pos[..., None] - k_pos[:, None] < window)
    s = torch.where(valid[:, :, None, None, :], s, MASK_VALUE)
    if shard is not None:
        s = shard(s, "scores")
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bckgs,bskd->bckgd", p, v_cache)
    return out.reshape(B, C, H, hd)


# ---------------------------------------------------------------------------
# paged KV cache (serve engine)
# ---------------------------------------------------------------------------
#
# The serve engine stores KV in a global page pool per attention layer
# instead of one dense (B, S, K, hd) buffer per stream. A *page* holds
# ``page_size`` consecutive token slots for every kv head; a stream owns
# an ordered list of pages (its *block table* row, shared by all layers
# since every layer caches the same token sequence). Token at absolute
# position ``t`` always lives at row ``t`` of its stream's gathered view
# (page ``t // page_size``, offset ``t % page_size``), so masks reduce to
# plain position comparisons and batched serving is independent of which
# physical pages a stream happened to get.
#
# ``kv_dtype='int8'`` stores codes + per-(token, head) scales from
# ``kernels.kvattn.quantize_kv`` and decodes single-token steps through
# ``kernels.kvattn.attend_int8_paged`` (on the card, the ``kv_decode``
# kernel's paged entry, which reads the pool through the block tables);
# float dtypes are the reference mode. Scales are stored float16, as in the
# JAX package: the resident-bytes win is the point of int8 KV.

PAGED_KV_DTYPES = ("int8", "float16", "bfloat16", "float32")
_POOL_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32}


def init_paged_kv(num_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, kv_dtype: str = "int8", device=None) -> Params:
    """One attention layer's share of the paged KV pool, zeroed on
    ``device``. int8 pools carry float16 ``k_scale``/``v_scale`` pages
    beside the code pages; float pools are just typed pages. Page 0 is the
    engine's write sink and is never handed to a stream."""
    if kv_dtype not in PAGED_KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {PAGED_KV_DTYPES}")
    shape = (num_pages, page_size, n_kv_heads, head_dim)
    if kv_dtype == "int8":
        return {
            "k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float16, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float16, device=device),
        }
    dt = _POOL_DTYPES[kv_dtype]
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def is_paged(cache: Params) -> bool:
    """A paged-pool cache node, as opposed to the dense ``{k, v, pos}``
    ring buffer."""
    return isinstance(cache, dict) and "k_pages" in cache


def _page_rows(block_tables: torch.Tensor, positions: torch.Tensor,
               page_size: int) -> torch.Tensor:
    """Flat pool-row index for each (stream, position). Writes with no
    real page (unallocated block-table entries (-1), positions past the
    table's capacity) land on page 0, the engine's write sink."""
    mp = block_tables.shape[1]
    pidx = positions // page_size
    page_ids = torch.gather(block_tables, 1, pidx.clamp(0, mp - 1).long())
    page_ids = torch.where(pidx < mp, page_ids, -1)
    return page_ids.clamp_min(0) * page_size + positions % page_size


def _flat(pool: torch.Tensor) -> torch.Tensor:
    """(num_pages, page_size, ...) pool as (rows, ...): a view, so writes
    through it land in the pool."""
    return pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])


def paged_append(cache: Params, k: torch.Tensor, v: torch.Tensor,
                 block_tables: torch.Tensor, positions: torch.Tensor,
                 page_size: int) -> Params:
    """Write C new tokens' K/V into the page pool, in place.

    k, v: (B, C, K, hd) float; block_tables (B, max_pages) int32 (-1 =
    unallocated); positions (B, C) absolute token positions. int8 pools
    quantize through ``quantize_kv`` (f32 scales, stored float16).
    Distinct streams own distinct pages; every inactive-slot write lands
    on page 0, where the winner of duplicate writes is undefined and never
    read (``paged_view`` masks page 0). Returns ``cache``.
    """
    B, C = positions.shape
    rows = _page_rows(block_tables, positions, page_size).reshape(-1).long()

    def scat(pool, vals):
        _flat(pool)[rows] = vals.reshape(B * C, *vals.shape[2:]).to(pool.dtype)

    if "k_scale" in cache:
        from ..kernels.kvattn.ops import quantize_kv

        k8, v8, ks, vs = quantize_kv(k, v)
        for name, vals in (("k_pages", k8), ("v_pages", v8),
                           ("k_scale", ks), ("v_scale", vs)):
            scat(cache[name], vals)
    else:
        scat(cache["k_pages"], k)
        scat(cache["v_pages"], v)
    return cache


def paged_attend(q: torch.Tensor, cache: Params, block_tables: torch.Tensor,
                 positions: torch.Tensor, page_size: int, *,
                 window: Optional[int] = None,
                 backend: str = "auto") -> torch.Tensor:
    """Attention over a paged KV cache: the read half of the handle.

    q: (B, C, H, hd); positions (B, C) absolute positions of the query
    tokens (already appended). Single-token int8 decode goes through
    ``attend_int8_paged`` before any gather (``backend`` picks the kernel,
    which reads the pool through the block tables, or the plain version
    over the gathered view); chunked-prefill reads (C > 1) and float pools
    dequantize the gathered view and share :func:`decode_attend`.
    """
    if "k_scale" in cache and q.shape[1] == 1:
        from ..kernels.kvattn.ops import attend_int8_paged

        out = attend_int8_paged(q[:, 0].contiguous(), cache, block_tables,
                                positions[:, 0].contiguous(), page_size,
                                window=window, backend=backend)
        return out[:, None]
    gather, kpos = paged_view(cache, block_tables, page_size)
    if "k_scale" in cache:
        k8, v8 = gather(cache["k_pages"]), gather(cache["v_pages"])
        ks = gather(cache["k_scale"]).to(torch.float32)
        vs = gather(cache["v_scale"]).to(torch.float32)
        k = (k8.to(torch.float32) * ks[..., None]).to(q.dtype)
        v = (v8.to(torch.float32) * vs[..., None]).to(q.dtype)
        return decode_attend(q, k, v, kpos, positions, window=window)
    k = gather(cache["k_pages"]).to(q.dtype)
    v = gather(cache["v_pages"]).to(q.dtype)
    return decode_attend(q, k, v, kpos, positions, window=window)
