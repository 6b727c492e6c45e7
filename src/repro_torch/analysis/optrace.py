"""One eager step's FLOPs, bytes and collective bytes.

The port's counterpart of the JAX package's ``repro.analysis.hlo``, which
parses a compiled XLA module into an ``HLOSummary``. Eager PyTorch compiles
no module, so :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` and reads every ATen op as it runs, with the
reference's accounting:

* **FLOPs**: the dots only, by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, the fused
  attention ops: ``2 * prod(out) * contracted``, the reference's dot
  formula); element-wise work is left out, as the reference leaves it out.
* **Bytes**: the reference's perfect-fusion model (``hlo.py``'s
  ``_MEM_OPS``): only ops that force a buffer count. Dots and reductions
  count their inputs and outputs; a gather (``index``, ``index_select``,
  ``gather``, ``embedding``) twice its output (read the slice, write it); an
  index write or slice copy (``index_put_``, ``copy_``) twice the values it
  writes, an accumulating scatter three times; collectives their inputs and
  outputs. Element-wise chains, views and factories count as fused: 0.
* **Collective bytes**: the bytes of each collective's operands, with the
  counts, from ``CommDebugMode`` (:func:`comm_mode`, which the dry run
  ``launch/dryrun.py`` shares).
* **The hand-written kernels**: ``ctypes`` calls that no dispatch mode
  sees. Each wrapper reports its calls through ``kernels/record.py``, whose
  FLOPs and bytes are added here in place of the plain version's ATen ops,
  so a step reads the same work on the card and on the CPU.
  ``fusion_dot_flops`` (the reference's dots inside fusions) holds the dots
  that run inside these fused kernels.

``roofline.from_step`` turns a :class:`StepSummary` into the roofline of
the step on one H100.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import record

__all__ = ["StepSummary", "analyze_step", "comm_mode", "op_bytes"]

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
         "_scaled_dot_product_efficient_attention", "_scaled_dot_product_flash_attention",
         "_scaled_dot_product_cudnn_attention",
         "_scaled_dot_product_flash_attention_for_cpu"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
               "_softmax", "_log_softmax", "var", "var_mean", "std", "std_mean",
               "linalg_vector_norm", "norm", "cumsum", "cumprod", "logsumexp", "sort",
               "topk", "any", "all", "native_layer_norm", "_fused_rms_norm"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
_WRITES = {"index_put", "index_put_", "_index_put_impl_", "index_copy", "index_copy_",
           "copy_", "slice_scatter", "select_scatter", "masked_scatter",
           "masked_scatter_"}
_ACCUMULATES = {"scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "index_add", "index_add_"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def op_bytes(name: str, args, kwargs, out) -> float:
    """The bytes one ATen op moves under the perfect-fusion model (module
    doc), by its overload packet's ``name``."""
    if name in _DOTS or name in _REDUCTIONS or "c10d" in name or name.startswith("all_"):
        return _nbytes(_tensors(list(args)) + _tensors(list(kwargs.values()))
                       + _tensors(out))
    if name in _GATHERS:
        return 2 * _nbytes(_tensors(out))
    if name in _WRITES:  # the values written: index_put's values, copy_'s source
        vals = args[2] if name.startswith(("index_put", "_index_put", "index_copy")) \
            else args[1] if len(args) > 1 else None
        return 2 * _nbytes(_tensors(vals))
    if name in _ACCUMULATES:
        vals = args[-1] if isinstance(args[-1], torch.Tensor) else kwargs.get("src")
        return 3 * _nbytes(_tensors(vals))
    return 0.0


@dataclasses.dataclass
class StepSummary:
    """The fields of the reference's ``HLOSummary``, and what the eager step
    adds: ``by_op`` (op or kernel -> calls, FLOPs, bytes), ``launches``
    (kernel -> wrapper calls) and ``weight_bytes`` (packed codes and scales
    the kernels read)."""

    flops: float
    bytes: float
    collective_bytes: float
    collective_counts: dict
    fusion_dot_flops: float  # dots inside the hand-written kernels
    by_op: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    weight_bytes: float = 0.0


class _StepCost(TorchDispatchMode):
    """Adds each ATen op's FLOPs and bytes, and each recorded kernel call's
    :class:`record.Work`; ops inside a recorded call are the plain version
    of that call and are left out."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.depth = 0
        self.flops = self.bytes = self.kernel_flops = self.weight_bytes = 0.0
        self.by_op: dict = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.launches: collections.Counter = collections.Counter()

    @contextlib.contextmanager
    def recorded(self, work: record.Work):
        if self.depth == 0:
            self.launches[work.kernel] += 1
            self.flops += work.flops
            self.kernel_flops += work.flops
            self.bytes += work.bytes
            self.weight_bytes += work.weight_bytes
            row = self.by_op[f"kernel.{work.kernel}"]
            row[0] += 1
            row[1] += work.flops
            row[2] += work.bytes
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (not self.depth and func.namespace == "aten"
                and func._overloadpacket not in self.registry):
            with self:  # a composite op (under inference mode) as the ops it runs
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self.depth:
            return out
        name = str(func.overloadpacket.__name__)
        fn = self.registry.get(func._overloadpacket)
        flops = float(fn(*args, **kwargs, out_val=out)) if fn is not None else 0.0
        nbytes = op_bytes(name, args, kwargs, out)
        if flops or nbytes:
            self.flops += flops
            self.bytes += nbytes
            row = self.by_op[f"aten.{name}"]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out


def comm_mode():
    """``CommDebugMode`` counting the bytes of each collective's local
    operands beside its counts (``.bytes``: collective -> bytes). Bytes are
    added for exactly the ops that ``CommDebugMode`` counts, under its
    names; the functional collectives' ``wait_tensor`` and
    ``_wrap_tensor_autograd`` are not collectives."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.comm_counts)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            # c10d's native ops take their outputs first, but for the in-place ones
            ins = args[1:2] if func.namespace == "c10d" and not str(
                func._overloadpacket.__name__).startswith(("allreduce", "broadcast")) \
                else args
            for op, n in self.comm_counts.items():
                if n != before.get(op, 0):
                    self.bytes[str(op).split(".")[-1]] += _nbytes(_tensors(list(ins)))
            return out

    return CommBytes()


def analyze_step(fn, args: tuple = (), kwargs=None) -> StepSummary:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and return its
    :class:`StepSummary` (module doc). The step runs as it would unobserved:
    on its arguments' device, through the kernels on the card."""
    comm, cost = comm_mode(), _StepCost()
    prev = record.set_recorder(cost.recorded)
    try:
        with comm, cost:
            fn(*args, **(kwargs or {}))
    finally:
        record.set_recorder(prev)
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    return StepSummary(
        flops=cost.flops, bytes=cost.bytes,
        collective_bytes=float(sum(comm.bytes.values())), collective_counts=counts,
        fusion_dot_flops=cost.kernel_flops,
        by_op={k: {"calls": c, "flops": f, "bytes": b}
               for k, (c, f, b) in sorted(cost.by_op.items(), key=lambda kv: -kv[1][2])},
        launches=dict(cost.launches), weight_bytes=cost.weight_bytes)
