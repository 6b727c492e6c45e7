"""Declarative rule engine for the port's audits.

The port of the JAX package's ``repro.analysis.audit.rules``:

* an :class:`AuditProgram` describes one real program — a callable plus
  example arguments, with declared expectations (the f32 shapes it must
  never produce, the arguments it writes in place, a same-structure
  second argument set) and the rules suppressed for it, each with its
  reason;
* a :class:`Rule` is a named check, registered with the :func:`rule`
  decorator (program rules) or :func:`register_catalog_rule` (kernel and
  AST rules, driven by their own modules) so the catalog stays
  introspectable (``scripts/run_audit_torch.py --list-rules``);
* :func:`run_program_rules` applies every program rule to every program.

The reference walks jaxprs and parses optimized HLO; the port runs the
program eagerly under a ``TorchDispatchMode`` and sees every ATen op with
its operands and outputs. Each of the reference's four program rules has
its eager counterpart here:

* ``no_materialized_f32_weight``: no f32 op output of a forbidden shape;
* ``donation_respected``: XLA's buffer donation is, in eager PyTorch, a
  write in place: the donated arguments keep their storage and come back
  as the same tensors, and no op makes a second full-size copy of one;
* ``no_host_transfer``: no op synchronises the device with the host (a
  scalar read, an output shape that depends on the data, a copy to the
  CPU); on a CUDA device, also whatever ``torch.cuda.set_sync_debug_mode``
  reports;
* ``stable_compile_cache``: a same-structure second call adds nothing to
  the port's caches of compiled work (the kernels' launch plans, the
  kernel libraries, calibration's unit programs).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Violation", "AuditProgram", "Rule", "rule", "register_catalog_rule",
           "registered_rules", "f32_outputs_matching", "tensor_leaves",
           "host_syncs", "cache_sizes", "run_program_rules"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One audited invariant broken at one place."""

    rule: str
    subject: str  # program name / kernel launch / file:line
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.subject}: {self.message}"


@dataclasses.dataclass
class AuditProgram:
    """One real program under audit: ``fn(*args)`` is run as it is served
    (eagerly, on the arguments' device). Expectations:

    * ``donate_argnums`` — the arguments the program writes in place (the
      reference's donated argnums; ``donation_respected``);
    * ``forbidden_f32`` — shapes (tuples) that must never appear as an f32
      op output (``no_materialized_f32_weight``);
    * ``repeat_args`` — a second argument set of the same structure;
      ``stable_compile_cache`` calls the program with both.

    ``suppress`` maps a rule name to the reason it is not applied to this
    program; :func:`run_program_rules` names each suppression and its
    reason."""

    name: str
    fn: Callable
    args: tuple
    donate_argnums: tuple = ()
    forbidden_f32: frozenset = frozenset()
    repeat_args: Optional[tuple] = None
    suppress: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    family: str  # 'program' | 'kernel' | 'ast'
    doc: str
    check: Optional[Callable] = None  # program rules: (AuditProgram) -> [Violation] | None


_RULES: dict[str, Rule] = {}


def rule(name: str, family: str = "program"):
    """Register a rule. Program-family rules are callables applied by
    :func:`run_program_rules`; kernel/ast rules register through
    :func:`register_catalog_rule` (their modules drive the checks)."""

    def deco(fn: Callable) -> Callable:
        _RULES[name] = Rule(name, family, (fn.__doc__ or "").strip(), fn)
        return fn

    return deco


def register_catalog_rule(name: str, family: str, doc: str) -> None:
    """Catalog entry for a rule implemented outside the program engine."""
    _RULES[name] = Rule(name, family, doc, None)


def registered_rules(family: Optional[str] = None) -> list[Rule]:
    rules = list(_RULES.values())
    if family is not None:
        rules = [r for r in rules if r.family == family]
    return sorted(rules, key=lambda r: (r.family, r.name))


class _F32Outputs(TorchDispatchMode):
    """Records (op name, shape) of every f32 op output whose shape is in
    ``shapes``."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = set(shapes)
        self.found: list[tuple[str, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and tuple(t.shape) in self.shapes):
                self.found.append((str(func.overloadpacket.__name__), tuple(t.shape)))
        return out


def f32_outputs_matching(fn: Callable, args: tuple, shapes) -> list[tuple[str, tuple]]:
    """(op name, shape) for every f32 op output of ``fn(*args)`` whose shape
    is in ``shapes``. The CUDA kernels' own work is invisible here: only the
    tensors the wrappers allocate show."""
    with torch.inference_mode(), _F32Outputs(shapes) as mode:
        fn(*args)
    return mode.found


@rule("no_materialized_f32_weight")
def check_no_materialized_f32_weight(prog: AuditProgram) -> list[Violation]:
    """No f32 op output anywhere in the program may have a forbidden
    full-dequant shape, e.g. a stacked MoE expert node's (E, K, N): serving
    consumes packed codes tile- or expert-wise, and the transient full
    dequant the grouped tier removed must not come back. None (not run)
    for a program with no forbidden shape: one without a stacked leaf."""
    if not prog.forbidden_f32:
        return None
    offenders = f32_outputs_matching(prog.fn, prog.args, prog.forbidden_f32)
    return [Violation(
        "no_materialized_f32_weight", prog.name,
        f"f32 {shape} materialized by op {op!r} (full dequantized weight "
        f"resident in the program)") for op, shape in offenders]


def tensor_leaves(tree) -> list:
    """The tensors of a nested tree of dicts, lists, tuples and dataclasses
    (``QState``), in traversal order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensor_leaves(getattr(tree, f.name))]
    return []


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _outputs(out) -> list:
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]


# a new tensor this large of a donated leaf's shape and dtype is a second
# copy of it (the reference: a dropped donation doubles the residency)
DONATION_COPY_BYTES = 1 << 20


class _Copies(TorchDispatchMode):
    """Records (op name, shape) of every op output of one of ``keys``
    ((shape, dtype)) of at least ``DONATION_COPY_BYTES`` whose storage is
    none of ``storages``: a new full-size tensor, not a view of a donated
    leaf."""

    def __init__(self, keys, storages):
        super().__init__()
        self.keys, self.storages = set(keys), set(storages)
        self.found: list[tuple[str, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _outputs(out):
            if ((tuple(t.shape), t.dtype) in self.keys
                    and t.numel() * t.element_size() >= DONATION_COPY_BYTES
                    and _storage(t) not in self.storages):
                self.found.append((str(func.overloadpacket.__name__), tuple(t.shape)))
        return out


@rule("donation_respected")
def check_donation_respected(prog: AuditProgram) -> list[Violation]:
    """The arguments in ``donate_argnums`` are written in place, the eager
    form of a donation: after one call every tensor leaf of them keeps its
    storage, shape and dtype; the program returns those same tensors; and
    no op makes a new tensor of a donated leaf's shape and dtype of 1 MiB or
    more that is not a view of it (a dropped donation doubles the residency
    of the KV cache or the optimizer state)."""
    if not prog.donate_argnums:
        return []
    donated = {i: tensor_leaves(prog.args[i]) for i in prog.donate_argnums}
    before = {i: [(_storage(t), tuple(t.shape), t.dtype) for t in ls]
              for i, ls in donated.items()}
    leaves = [t for ls in donated.values() for t in ls if t.numel()]
    mode = _Copies({(tuple(t.shape), t.dtype) for t in leaves},
                   {_storage(t) for t in leaves})
    with mode:
        out = prog.fn(*prog.args)
    returned = {_storage(t) for t in tensor_leaves(out) if t.numel()}
    found = []
    for i in prog.donate_argnums:
        after = [(_storage(t), tuple(t.shape), t.dtype)
                 for t in tensor_leaves(prog.args[i])]
        moved = sum(a != b for a, b in zip(before[i], after)) + abs(
            len(after) - len(before[i]))
        if moved:
            found.append(Violation(
                "donation_respected", prog.name,
                f"argnum {i}: {moved}/{len(before[i])} of its tensors were replaced "
                f"(new storage, shape or dtype) instead of written in place"))
        lost = sum(s not in returned for s, *_ in before[i] if s)
        if lost:
            found.append(Violation(
                "donation_respected", prog.name,
                f"argnum {i}: the program returns new tensors for {lost}/"
                f"{len(before[i])} of its tensors instead of the donated ones"))
    for (op, shape), n in collections.Counter(mode.found).items():
        found.append(Violation(
            "donation_respected", prog.name,
            f"op {op!r} made {n} new {shape} tensor(s) of a donated leaf's shape "
            f"and dtype (a second copy of it)"))
    return found


# ops whose outputs' shapes depend on the data, so the host must read it
_DATA_SHAPED = {"nonzero", "masked_select", "unique", "_unique", "_unique2", "unique_dim",
                "unique_consecutive", "unique_dim_consecutive"}


class _HostSyncs(TorchDispatchMode):
    """Counts the ops that synchronise the device with the host: a scalar
    read (``_local_scalar_dense``: ``.item()``, ``.tolist()``, ``bool()``,
    ``int()``), an output shaped by the data, a ``repeat_interleave`` with
    no ``output_size``, a copy from a non-CPU device to the CPU. With
    ``sync_debug`` (CUDA), every op that ``set_sync_debug_mode("error")``
    refuses is counted too, and run again with the check off."""

    def __init__(self, sync_debug: bool = False):
        super().__init__()
        self.sync_debug = sync_debug
        self.found: collections.Counter = collections.Counter()
        self.device_found: collections.Counter = collections.Counter()

    def _host_bound(self, name, func, args, kwargs) -> bool:
        if name == "_local_scalar_dense" or name in _DATA_SHAPED:
            return True
        if name == "repeat_interleave":  # repeats held in a tensor (not an int)
            return func._overloadname != "self_int" and kwargs.get("output_size") is None
        if name == "_to_copy":
            dev = kwargs.get("device")
            return (dev is not None and torch.device(dev).type == "cpu"
                    and args[0].device.type != "cpu")
        if name in ("copy_", "copy"):
            return args[0].device.type == "cpu" and args[1].device.type != "cpu"
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "aten":
            with self:  # a composite op (under inference mode) as the ops it runs
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        name = str(func.overloadpacket.__name__)
        if self._host_bound(name, func, args, kwargs):
            self.found[f"aten.{name}"] += 1
        if not self.sync_debug:
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            self.device_found[f"aten.{name}"] += 1
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return func(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)


class _HostReads(TorchFunctionMode):
    """Counts the tensor methods that read a tensor's memory on the host
    without an ATen op a dispatch mode would see (``tolist``, ``numpy``),
    into ``found``."""

    _READS = {torch.Tensor.tolist: "Tensor.tolist", torch.Tensor.numpy: "Tensor.numpy"}

    def __init__(self, found: collections.Counter):
        super().__init__()
        self.found = found

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = self._READS.get(func)
        if name is not None:
            self.found[name] += 1
        return func(*args, **(kwargs or {}))


def host_syncs(fn: Callable, args: tuple, sync_debug: bool = False):
    """Run ``fn(*args)`` once under :class:`_HostSyncs`; returns (the ops the
    mode flags, the ops only the sync debug mode reports), each a Counter of
    op name -> calls. ``sync_debug`` runs the call under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    mode = _HostSyncs(sync_debug)
    prev = torch.cuda.get_sync_debug_mode() if sync_debug else None
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with _HostReads(mode.found), mode:
            fn(*args)
    finally:
        if sync_debug:
            torch.cuda.set_sync_debug_mode(prev)
    only = collections.Counter({k: v for k, v in mode.device_found.items()
                                if k not in mode.found})
    return mode.found, only


def _on_cuda(args) -> bool:
    return any(t.is_cuda for t in tensor_leaves(args))


@rule("no_host_transfer")
def check_no_host_transfer(prog: AuditProgram) -> list[Violation]:
    """No op of a hot program synchronises the device with the host: no
    scalar read (``.item()``, ``.tolist()``, ``bool()``, ``int()``), no op
    whose output shape depends on the data (``nonzero``, ``masked_select``,
    the ``unique`` family, ``repeat_interleave`` without ``output_size``),
    no copy from the device to the CPU. A dispatch mode makes the same check
    on the CPU and the card; on a CUDA device the program also runs once
    under ``torch.cuda.set_sync_debug_mode("error")``, and a sync only the
    card reports is a violation too. A synchronising step cannot be captured
    in a CUDA graph."""
    found, _ = host_syncs(prog.fn, prog.args)
    only = collections.Counter()
    if _on_cuda(prog.args):
        torch.cuda.synchronize()
        _, only = host_syncs(prog.fn, prog.args, sync_debug=True)
    out = [Violation("no_host_transfer", prog.name,
                     f"host sync: op {op!r} x{n} a call") for op, n in found.items()]
    out += [Violation("no_host_transfer", prog.name,
                      f"host sync reported by the CUDA sync debug mode: op {op!r} "
                      f"x{n} a call") for op, n in only.items()]
    return out


def cache_sizes() -> dict:
    """The size of each of the port's caches of compiled work: every
    launch-plan cache of ``kernels/spec.py`` (``functools.lru_cache``), the
    kernel libraries ``kernels/build.py`` has loaded, and the misses of
    calibration's program caches (``core/calib_loop.cache_stats``)."""
    import functools

    from ...core import calib_loop
    from ...kernels import build, spec

    sizes = {f"spec.{name}": fn.cache_info().currsize
             for name, fn in sorted(vars(spec).items())
             if isinstance(fn, functools._lru_cache_wrapper)}
    sizes["build.libraries"] = len(build.LOADED)
    stats = calib_loop.cache_stats()
    sizes.update({f"calib_loop.{k}": v for k, v in stats.items() if k.endswith("_misses")})
    return sizes


@rule("stable_compile_cache")
def check_stable_compile_cache(prog: AuditProgram) -> list[Violation]:
    """Two calls with arguments of the same structure must reuse what the
    first call built: the second adds nothing to a launch-plan cache, the
    set of kernel libraries or calibration's program caches. Growth means a
    cache keys on object identity or mutable state, and every serving or
    calibration step would plan or build again."""
    if prog.repeat_args is None:
        return []
    prog.fn(*prog.args)
    n1 = cache_sizes()
    prog.fn(*prog.repeat_args)
    n2 = cache_sizes()
    grown = [f"{k} {n1[k]} -> {n2[k]}" for k in n1 if n2[k] > n1[k]]
    if grown:
        return [Violation("stable_compile_cache", prog.name,
                          "second same-structure call grew the compile cache: "
                          + ", ".join(grown))]
    return []


PROGRAM_RULES = ("no_materialized_f32_weight", "donation_respected",
                 "no_host_transfer", "stable_compile_cache")


def run_program_rules(programs, rules: Optional[tuple] = None,
                      verbose: Callable[[str], None] = lambda s: None,
                      skipped: Optional[list] = None) -> list[Violation]:
    """Apply every program rule that is not suppressed to every program. A
    suppressed rule is named with its reason through ``verbose``; it, and a
    rule that has nothing to check in a program (its check returns None),
    are reported as skipped, and (program, rule) is appended to ``skipped``
    when given."""
    names = rules if rules is not None else PROGRAM_RULES
    out: list[Violation] = []
    for prog in programs:
        for name in names:
            if name in prog.suppress:
                verbose(f"  suppressed {name} on {prog.name}: {prog.suppress[name]}")
                if skipped is not None:
                    skipped.append((prog.name, name))
                continue
            found = _RULES[name].check(prog)
            if found is None:
                verbose(f"  {prog.name}: {name} -> skipped (nothing to check)")
                if skipped is not None:
                    skipped.append((prog.name, name))
                continue
            verbose(f"  {prog.name}: {name} -> "
                    + (f"{len(found)} violation(s)" if found else "ok"))
            out.extend(found)
    return out
