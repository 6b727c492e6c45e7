"""Budgeted mixed-precision deployment (BRECQ Sec. 3.4, CalibTIP-style).

The port of the JAX package's ``repro.deploy.budget``. Give it a budget —
artifact bytes or decode milliseconds — and it ships the best servable
artifact under it:

* :mod:`.solver` — exact constrained bit assignment over a sensitivity
  table (Pareto-merge DP, brute-force-verified), with a Lagrangian
  approximation and the genetic search as a cross-check baseline.
* :mod:`.cost` — per-(path, bits) cost tables: container-aware bytes,
  or measured per-layer qmm tier time (the kernels replayed from a CUDA
  graph on the card), which doubles as the measured dispatch table
  replacing the ``DECODE_M_MAX`` heuristic.
* :mod:`.apply` — assignment → packed artifact: storage-stack groups,
  the calibration-free RTN proxy sensitivity, per-layer mixed RTN
  packing with container promotion, and the one-call
  :func:`budget_artifact` behind ``serve --budget-bytes/--budget-decode-ms``.
"""
from .apply import (budget_artifact, rtn_mixed_artifact, storage_groups,
                    weight_sens_table, weight_shapes)
from .cost import (CostTable, bytes_cost_table, ensure_cost_table,
                   install_dispatch, measure_cost_table)
from .solver import (BudgetInfeasibleError, BudgetSolution, brute_force,
                     grouped_problem, solve_budget)

__all__ = [
    "BudgetInfeasibleError", "BudgetSolution", "CostTable",
    "brute_force", "budget_artifact", "bytes_cost_table",
    "ensure_cost_table", "grouped_problem", "install_dispatch",
    "measure_cost_table", "rtn_mixed_artifact", "solve_budget",
    "storage_groups", "weight_sens_table", "weight_shapes",
]
