"""Declarative rule engine for the port's audits.

The port of the JAX package's ``repro.analysis.audit.rules``:

* an :class:`AuditProgram` describes one real program — a callable plus
  example arguments, with the f32 shapes it must never produce;
* a :class:`Rule` is a named check, registered with the :func:`rule`
  decorator (program rules) or :func:`register_catalog_rule` (kernel and
  AST rules, driven by their own modules) so the catalog stays
  introspectable (``scripts/run_audit_torch.py --list-rules``);
* :func:`run_program_rules` applies every program rule to every program.

The reference walks jaxprs; the port runs the program eagerly under a
``TorchDispatchMode`` and sees every ATen op's outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Violation", "AuditProgram", "Rule", "rule", "register_catalog_rule",
           "registered_rules", "f32_outputs_matching", "run_program_rules"]


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
    (eagerly, on the arguments' device). ``forbidden_f32`` holds shapes
    (tuples) that must never appear as an f32 op output
    (``no_materialized_f32_weight``)."""

    name: str
    fn: Callable
    args: tuple
    forbidden_f32: frozenset = frozenset()


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


PROGRAM_RULES = ("no_materialized_f32_weight",)


def run_program_rules(programs, rules: Optional[tuple] = None,
                      verbose: Callable[[str], None] = lambda s: None,
                      skipped: Optional[list] = None) -> list[Violation]:
    """Apply every program rule to every program. A rule that has nothing
    to check in a program (its check returns None) is reported as
    skipped, and (program, rule) is appended to ``skipped`` when given."""
    names = rules if rules is not None else PROGRAM_RULES
    out: list[Violation] = []
    for prog in programs:
        for name in names:
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
