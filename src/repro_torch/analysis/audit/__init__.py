"""Static audits of the port: one program rule, the CUDA kernels' launch
contracts and AST lints over the port's sources.

Three rule families, one entry point (``scripts/run_audit_torch.py``):

* ``program`` — ``no_materialized_f32_weight``: a real program (the qmm
  tiers) run under a ``TorchDispatchMode`` must produce no f32 tensor of a
  stacked packed leaf's full dequantized shape. The reference's three
  XLA rules (``donation_respected``, ``no_host_transfer``,
  ``stable_compile_cache``) are not ported (ROADMAP 15c).
* ``kernel`` — every launch the port's dispatch would issue over the 11
  registered configs at full width, through ``kernels/spec.py``'s
  ``describe_*`` and ``plan_*``: the shape contract and the shared memory
  a block asks for against ``SMEM_PER_BLOCK``.
* ``ast`` — stdlib-``ast`` lints over the port's sources: host syncs inside
  a captured CUDA graph, mutable defaults, bare asserts under
  ``kernels/``, a plain ``backend="torch"`` default on a kernel path.
"""
from .rules import (AuditProgram, Rule, Violation,  # noqa: F401
                    register_catalog_rule, registered_rules, rule,
                    run_program_rules)
