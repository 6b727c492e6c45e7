"""Mesh sharding plans: path-based partition rules for every step input.

The port of the JAX package's ``repro.dist.sharding``. A :class:`Plan`
binds a named mesh (axes drawn from ``pod``/``data``/``model``), one
parallelism strategy and an :class:`ArchConfig`, and answers one question
for the step builders in ``launch/steps.py``: *how is this leaf laid out
over the mesh?* The rules are JAX's, rule for rule, keyed on the leaf's
tree path and shape (``{'w': (K, N)}`` linears, stacked ``(L, ...)``
leaves, stacked ``(E, K, N)`` MoE experts).

A *spec* is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names, equal entry for entry to JAX's ``PartitionSpec``
(a one-axis tuple is written as the name, as ``PartitionSpec`` does).
:func:`placements` turns a spec into the DTensor placements of a
``DeviceMesh``: ``Shard(d)`` or ``Replicate()`` per mesh dim.

Strategies
----------
``dp``
    Params/opt replicated; the batch shards over every mesh axis that
    divides it (including ``model``, so a pure-DP mesh is fully used).
``tp``
    Megatron tensor parallelism over ``model``: column-parallel
    in-projections shard N, row-parallel out-projections shard K, norms,
    biases and gains replicate, the embedding table is vocab-parallel, MoE
    expert stacks shard E over ``model``. Batch shards over ``pod``+``data``.
``fsdp``
    ``tp`` rules plus weight sharding over ``fsdp_axis`` (default
    ``data``) on the other matrix dim. Expert stacks keep E over
    ``model`` and put their role dim over ``fsdp_axis``.
``zero3``
    No tensor parallelism: every matrix-like leaf shards its largest
    divisible dim over the joint axes tuple (all mesh axes).

Packed-int leaves (the ``repro_torch.deploy`` artifact format): int8 codes
``w: (..., K*cbits/8, N)`` shard along N only (plus E for expert stacks);
the packed row dim never shards (sub-byte codes interleave values across a
byte). ``qscale`` siblings replicate; the int8 embedding ``table`` keeps
the vocab-parallel rule and ``table_qscale`` replicates.

Every axis assignment is guarded by divisibility: a dim that does not
divide the axis size replicates instead of failing.

``estimate_params`` counts a config's params under ``FakeTensorMode``
(JAX traces ``model.init`` under ``jax.eval_shape``), so even
llama-3.2-vision-90b (about 360 GB of f32) is counted without allocating.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Any, Sequence

from ..configs.base import ArchConfig

Params = Any

STRATEGIES = ("dp", "tp", "fsdp", "zero3")

# parent-node names classifying a {'w': ...} leaf's matmul role.
COL_PARENTS = frozenset({
    "wq", "wk", "wv",            # attention / mlstm in-projections
    "w_gate", "w_up",            # (shared-)MLP in-projections
    "in_proj", "w_in", "w_if",   # ssm / xlstm fused in-projections
    "w_dt", "wB", "wC",          # mamba coefficient projections
    "head",                      # lm head: (d, V), vocab is the out dim
})
ROW_PARENTS = frozenset({"wo", "w_down", "out_proj"})
EXPERT_PARENTS = frozenset({"w_gate", "w_up", "w_down"})

_SEQ_TILE = 128  # minimum per-shard seq chunk for sequence parallelism


def P(*entries) -> tuple:
    """A spec, entries normalised as JAX's ``PartitionSpec`` has them: a
    one-axis tuple is the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _keys(path: Sequence[Any]) -> tuple[str, ...]:
    """Key path -> plain strings (strings, or objects with a ``.key``)."""
    return tuple(str(getattr(k, "key", k)) for k in path)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[Any], mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a :class:`MeshSpec` or
    anything with ``axis_names``): ``Shard(d)`` on the mesh dim of each
    axis that shards tensor dim ``d``, ``Replicate()`` elsewhere.

    A dim sharded over several axes must list them in mesh order (DTensor
    splits a dim over mesh dims major first, as JAX splits it over the
    axes of a tuple); any other order, an unknown axis or an axis used
    twice raises instead of giving another layout."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out: list = [Replicate() for _ in names]
    used: set = set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not in "
                                 f"the mesh's {names}")
            if a in used:
                raise ValueError(f"spec {tuple(spec)} uses axis {a!r} twice")
            used.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)} splits dim {d} over {axes}, "
                             f"not in the mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Sequence[Any], mesh) -> tuple:
    """The shard shape of a ``shape`` leaf laid out by ``spec`` (every
    sharded dim divides, as the rules guarantee): JAX's
    ``NamedSharding(mesh, spec).shard_shape(shape)``."""
    sizes = mesh.shape
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide {n}")
        out[d] //= n
    return tuple(out)


@dataclasses.dataclass
class Plan:
    """Sharding plan: (mesh, strategy, arch) -> per-leaf specs.

    Args:
      mesh: a :class:`~repro_torch.launch.mesh.MeshSpec`; axes from
        ``("pod", "data", "model")``.
      strategy: one of :data:`STRATEGIES`.
      cfg: the architecture the plan serves (kept for provenance).
      fsdp_axis: axis weight sharding uses under ``fsdp``.
      shard_experts: shard stacked MoE expert dims over ``model``.
      seq_parallel: sequence-shard block-boundary activations over
        ``model`` for tp/fsdp when the seq length tiles.
    """

    mesh: Any
    strategy: str
    cfg: ArchConfig
    fsdp_axis: str = "data"
    shard_experts: bool = True
    seq_parallel: bool = True

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"expected one of {STRATEGIES}")
        if self.strategy == "fsdp" and self.fsdp_axis not in self.mesh.shape:
            raise ValueError(f"fsdp_axis {self.fsdp_axis!r} not a mesh axis "
                             f"{tuple(self.mesh.shape)}")

    # -- mesh helpers --------------------------------------------------------

    def _axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        size = 1
        for a in axes:
            if a not in self.mesh.shape:
                return 0
            size *= self.mesh.shape[a]
        return size

    @property
    def _model_size(self) -> int:
        return self.mesh.shape.get("model", 0)

    def placements(self, spec) -> list:
        return placements(spec, self.mesh)

    # -- batch ---------------------------------------------------------------

    def batch_axes(self, global_batch: int) -> tuple[str, ...]:
        """Mesh axes the batch dim shards over, in mesh order, greedily
        keeping the joint product a divisor of ``global_batch``."""
        if self.strategy == "dp":
            cand = tuple(self.mesh.axis_names)
        else:
            cand = tuple(a for a in self.mesh.axis_names if a in ("pod", "data"))
        axes: list[str] = []
        prod = 1
        for a in cand:
            n = self.mesh.shape[a]
            if n > 1 and global_batch % (prod * n) == 0:
                axes.append(a)
                prod *= n
        return tuple(axes)

    def _seq_shard_ok(self, seq_len: int, baxes: tuple[str, ...]) -> bool:
        return (self.seq_parallel and self.strategy in ("tp", "fsdp")
                and self._model_size > 1 and "model" not in baxes
                and seq_len > 0
                and seq_len % (self._model_size * _SEQ_TILE) == 0)

    def batch_spec(self, global_batch: int, ndim: int,
                   seq_axis: int = 1, seq_len: int = 0) -> tuple:
        """Spec for one batch leaf: dim 0 over :meth:`batch_axes`;
        optionally dim ``seq_axis`` over ``model`` (sequence parallelism)
        when ``seq_len`` tiles over the model axis."""
        baxes = self.batch_axes(global_batch)
        spec: list[Any] = [None] * ndim
        spec[0] = baxes if baxes else None
        if 0 < seq_axis < ndim and self._seq_shard_ok(seq_len, baxes):
            spec[seq_axis] = "model"
        return P(*spec)

    def batch_specs(self, batch: Params, global_batch: int,
                    shard_seq: bool = True) -> Params:
        """Specs for a batch tree (tokens / patches / frames): batch dim
        over the data axes, seq dim over ``model`` when ``shard_seq`` and
        the length tiles."""

        def leaf(x):
            ndim = len(x.shape)
            seq_len = x.shape[1] if (shard_seq and ndim >= 2) else 0
            return self.batch_spec(global_batch, ndim, 1, seq_len)

        return _tree_map(leaf, batch)

    def batch_placements(self, batch: Params, global_batch: int,
                         shard_seq: bool = True) -> Params:
        return _tree_map(self.placements, self.batch_specs(batch, global_batch, shard_seq),
                         is_leaf=_is_spec)

    # -- params --------------------------------------------------------------

    def param_spec(self, path: Sequence[Any], shape: Sequence[int]) -> tuple:
        """Spec for one fp param leaf from its tree path (strings, or keys
        with a ``.key``) and its global shape, leading stack dim included."""
        return self._param_spec(_keys(path), tuple(shape))

    def _param_spec(self, keys: tuple[str, ...], shape: tuple[int, ...]) -> tuple:
        ndim = len(shape)
        spec: list[Any] = [None] * ndim
        leaf = keys[-1] if keys else ""
        parent = keys[-2] if len(keys) > 1 else ""
        gparent = keys[-3] if len(keys) > 2 else ""
        if self.strategy == "dp" or ndim < 2:
            return P(*spec)
        if leaf in ("qscale", "table_qscale") or parent == "router":
            return P(*spec)  # scales replicate; the MoE router stays FP+small

        if leaf == "table":  # embedding: vocab-parallel (megatron)
            return self._matrix_spec(spec, shape, role_dim=ndim - 2,
                                     other_dim=ndim - 1)
        if leaf != "w":
            return P(*spec)  # norms, biases, gates, convs, pos tables

        if parent in EXPERT_PARENTS and gparent == "moe" and ndim >= 3:
            return self._expert_spec(spec, shape, parent)
        if parent in COL_PARENTS:
            return self._matrix_spec(spec, shape, role_dim=ndim - 1,
                                     other_dim=ndim - 2)
        if parent in ROW_PARENTS:
            return self._matrix_spec(spec, shape, role_dim=ndim - 2,
                                     other_dim=ndim - 1)
        return P(*spec)  # unknown weight: replicate rather than guess

    def _zero3_spec(self, spec: list, shape: tuple[int, ...]) -> tuple:
        joint = tuple(self.mesh.axis_names)
        size = self._axis_size(joint)
        for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if size > 1 and shape[dim] % size == 0:
                spec[dim] = joint
                break
        return P(*spec)

    def _matrix_spec(self, spec: list, shape: tuple[int, ...],
                     role_dim: int, other_dim: int) -> tuple:
        """tp: role dim over ``model``; fsdp: + other dim over
        ``fsdp_axis``; zero3: largest divisible dim over the joint axes."""
        if self.strategy == "zero3":
            return self._zero3_spec(spec, shape)
        if self._model_size > 1 and shape[role_dim] % self._model_size == 0:
            spec[role_dim] = "model"
        if self.strategy == "fsdp" and self.fsdp_axis != "model":
            fs = self._axis_size(self.fsdp_axis)
            if fs > 1 and shape[other_dim] % fs == 0:
                spec[other_dim] = self.fsdp_axis
        return P(*spec)

    def _expert_spec(self, spec: list, shape: tuple[int, ...],
                     parent: str) -> tuple:
        """Stacked experts ``(..., E, K, N)``: E over ``model`` (EP);
        fsdp additionally shards the role dim over ``fsdp_axis``."""
        ndim = len(shape)
        if self.strategy == "zero3":
            return self._zero3_spec(spec, shape)
        e_dim = ndim - 3
        role_dim = ndim - 2 if parent in ROW_PARENTS else ndim - 1
        other_dim = ndim - 1 if role_dim == ndim - 2 else ndim - 2
        e_sharded = (self.shard_experts and self._model_size > 1
                     and shape[e_dim] % self._model_size == 0)
        if e_sharded:
            spec[e_dim] = "model"
        elif self._model_size > 1 and shape[role_dim] % self._model_size == 0:
            spec[role_dim] = "model"  # EP off/impossible: plain tp rule
        if self.strategy == "fsdp" and self.fsdp_axis != "model":
            fs = self._axis_size(self.fsdp_axis)
            dim = role_dim if e_sharded else other_dim
            if fs > 1 and shape[dim] % fs == 0 and spec[dim] is None:
                spec[dim] = self.fsdp_axis
        return P(*spec)

    def _packed_spec(self, keys: tuple[str, ...], shape: tuple[int, ...]) -> tuple:
        """Spec for packed int8 codes: N (and E) only."""
        ndim = len(shape)
        spec: list[Any] = [None] * ndim
        parent = keys[-2] if len(keys) > 1 else ""
        gparent = keys[-3] if len(keys) > 2 else ""
        if self.strategy == "dp" or ndim < 2:
            return P(*spec)
        if self.strategy == "zero3":
            joint = tuple(self.mesh.axis_names)
            size = self._axis_size(joint)
            if size > 1 and shape[-1] % size == 0:
                spec[-1] = joint
            return P(*spec)
        n_axis = "model"
        if (parent in EXPERT_PARENTS and gparent == "moe" and ndim >= 3
                and self.shard_experts and self._model_size > 1
                and shape[ndim - 3] % self._model_size == 0):
            spec[ndim - 3] = "model"
            n_axis = self.fsdp_axis if self.strategy == "fsdp" else None
        if (n_axis and self._axis_size(n_axis) > 1
                and shape[-1] % self._axis_size(n_axis) == 0):
            spec[-1] = n_axis
        return P(*spec)

    def params_spec(self, params: Params) -> Params:
        """Specs for a whole param tree, fp or packed (tensors, fake or
        real). Packed nodes are told apart by their ``qscale`` /
        ``table_qscale`` sibling and get the packed-leaf rules."""

        def walk(node, keypath):
            if not isinstance(node, dict):
                return self._param_spec(keypath, tuple(node.shape))
            if "qscale" in node or "table_qscale" in node:
                out = {}
                for k, v in node.items():
                    if k == "w":
                        out[k] = self._packed_spec(keypath + (k,), tuple(v.shape))
                    elif k == "table":
                        out[k] = self._param_spec(keypath + (k,), tuple(v.shape))
                    else:  # qscale / table_qscale / bias: small, replicated
                        out[k] = P(*([None] * len(v.shape)))
                return out
            return {k: walk(v, keypath + (k,)) for k, v in node.items()}

        return walk(params, ())

    def opt_spec(self, opt_tree: Params) -> Params:
        """Optimizer-moment trees mirror the param tree layout."""
        return self.params_spec(opt_tree)

    def params_placements(self, params: Params) -> Params:
        return _tree_map(self.placements, self.params_spec(params), is_leaf=_is_spec)

    # -- caches --------------------------------------------------------------

    def cache_spec(self, path: Sequence[Any], shape: Sequence[int],
                   global_batch: int) -> tuple:
        """Spec for one stacked cache leaf ``(L, B, ...)``: batch dim over
        the data axes; the largest trailing dim (seq slots for KV caches,
        the inner dim for recurrent states) over ``model`` when free and
        divisible. ``path`` is kept for symmetry with :meth:`param_spec`."""
        del path
        return self._cache_spec(tuple(shape), global_batch)

    def _cache_spec(self, shape: tuple[int, ...], global_batch: int) -> tuple:
        ndim = len(shape)
        spec: list[Any] = [None] * ndim
        if ndim < 2:
            return P(*spec)
        baxes = self.batch_axes(shape[1] if shape[1] else global_batch)
        spec[1] = baxes if baxes else None
        if ndim >= 3 and self._model_size > 1 and "model" not in baxes:
            j = max(range(2, ndim), key=lambda d: shape[d])
            if shape[j] % self._model_size == 0:
                spec[j] = "model"
        return P(*spec)

    def cache_specs(self, cache: Params, global_batch: int) -> Params:
        return _tree_map(lambda x: self._cache_spec(tuple(x.shape), global_batch), cache)

    def cache_placements(self, cache: Params, global_batch: int) -> Params:
        return _tree_map(self.placements, self.cache_specs(cache, global_batch),
                         is_leaf=_is_spec)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _tree_map(fn, tree, is_leaf=None):
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# strategy selection + param counting
# ---------------------------------------------------------------------------


def pick_strategy(cfg: ArchConfig, kind: str) -> str:
    """Default strategy for an (arch, step-kind) cell.

    Serving (prefill/decode) always runs tensor-parallel: weights stay
    resident over ``model`` and the small per-step batch shards over the
    data axes. Training is data-parallel for models that fit replicated
    and fsdp for MoE / multi-billion-param models.
    """
    if kind in ("prefill", "decode"):
        return "tp"
    if cfg.moe is not None or estimate_params(cfg) > 2e9:
        return "fsdp"
    return "dp"


def fake_init(cfg: ArchConfig, mode=None):
    """``model.init`` of ``cfg`` under ``FakeTensorMode`` (``mode``, or a
    new one): the params tree with the real shapes and dtypes, and no
    storage. Imports torch only when called, so the roofline's constants
    import without it."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.registry import build_model

    model = build_model(cfg)
    with mode or FakeTensorMode():
        return model.init(torch.Generator().manual_seed(0))


@lru_cache(maxsize=None)
def _count_params(cfg: ArchConfig) -> float:
    from ..interop import tree_leaves

    return float(sum(math.prod(leaf.shape) for leaf in tree_leaves(fake_init(cfg))))


def estimate_params(cfg: ArchConfig) -> float:
    """Exact parameter count for a config: the model's own ``init`` run
    under ``FakeTensorMode`` (shapes only, no allocation), cached per
    config. Consumed by the roofline's model FLOPs and bytes."""
    return _count_params(cfg)
