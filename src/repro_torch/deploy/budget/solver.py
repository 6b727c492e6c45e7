"""Exact budgeted mixed-precision solver (CalibTIP direction).

The port of the JAX package's ``repro.deploy.budget.solver`` (pure
Python/numpy, kept as its own copy: the same problem gives the same
assignment in both packages).

``solve_budget`` picks per-layer bit widths from a small choice set to
minimize the predicted task loss of a
:class:`~repro_torch.core.sensitivity.SensTable` — the diagonal per-layer
sensitivities plus the tabulated 2-bit intra-block pair interactions,
i.e. exactly the objective :func:`repro_torch.core.mixed_precision.fitness`
scores — subject to a budget on any per-(path, bits) additive cost
(:class:`.cost.CostTable`: model bytes or measured decode latency).

Method (``method='exact'``): the interaction terms only couple paths
inside a block, so the assignment graph decomposes into small
*components* (connected via offdiag pairs and group ties). Each
component is enumerated exhaustively and reduced to its Pareto-optimal
(cost, loss) options; components are then combined by a Pareto-merge
dynamic program (pruning a dominated partial sum is safe because costs
and losses add). The optimum of the constrained problem lies on the
merged frontier, so the result is exact — verified against brute-force
enumeration (:func:`brute_force`). The genetic search of
``core.mixed_precision`` is kept as a cross-check baseline (it can never
win).

``method='lagrange'`` is the fast approximate path for very large
instances: a bisection on the multiplier of ``loss + lam * cost`` that
returns the best feasible convex-hull point.

Groups: ``groups`` maps paths to a shared key; tied paths must take the
same bits. Deployment flows tie each storage stack (stacked leaves share
one int container, so per-layer splits inside a stack buy no bytes and
no latency).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Hashable, Mapping, Optional, Sequence

from ...core.mixed_precision import BIT_CHOICES, fitness
from ...core.sensitivity import SensTable

# Largest per-component joint enumeration. Components are blocks (a
# handful of linears) or tied stacks; 3^12 is far beyond any real model.
MAX_COMPONENT_ENUM = 3 ** 12


class BudgetInfeasibleError(ValueError):
    """No assignment satisfies the budget (even the cheapest one)."""


@dataclasses.dataclass
class BudgetSolution:
    """Result of :func:`solve_budget`.

    ``assign`` maps every path of the sensitivity table's domain to its
    chosen bits; ``predicted_loss`` is the table objective
    (:func:`~repro_torch.core.mixed_precision.fitness`) and ``cost`` the cost
    table's value of the assignment — both recomputed from ``assign`` so
    they can be compared directly against other searchers.
    """

    assign: dict[str, int]
    predicted_loss: float
    cost: float
    budget: float
    kind: str  # cost-table kind ("bytes" | "decode_ms" | ...)
    method: str
    n_frontier: int = 0  # Pareto points surviving the final merge

    def to_json(self) -> dict:
        hist: dict[str, int] = {}
        for b in self.assign.values():
            hist[str(b)] = hist.get(str(b), 0) + 1
        return {"predicted_loss": self.predicted_loss, "cost": self.cost,
                "budget": self.budget, "kind": self.kind,
                "method": self.method, "n_frontier": self.n_frontier,
                "bits_histogram": hist}


def _normalize_groups(paths: Sequence[str],
                      groups: Optional[Mapping[str, Hashable]]
                      ) -> dict[str, Hashable]:
    if groups is None:
        return {p: p for p in paths}
    missing = [p for p in paths if p not in groups]
    if missing:
        raise KeyError(f"groups is missing {len(missing)} paths, e.g. "
                       f"{missing[0]!r}")
    return {p: groups[p] for p in paths}


def _components(paths: Sequence[str], group_of: Mapping[str, Hashable],
                pairs: Sequence[tuple[str, str]]) -> list[list[Hashable]]:
    """Connected components over *groups*: offdiag pairs couple the two
    endpoint groups; tied paths are already one group."""
    parent: dict[Hashable, Hashable] = {group_of[p]: group_of[p] for p in paths}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for p1, p2 in pairs:
        r1, r2 = find(group_of[p1]), find(group_of[p2])
        if r1 != r2:
            parent[r2] = r1
    comps: dict[Hashable, list[Hashable]] = {}
    for g in dict.fromkeys(group_of[p] for p in paths):  # stable order
        comps.setdefault(find(g), []).append(g)
    return list(comps.values())


def _pareto(options: list[tuple[float, float, tuple]]
            ) -> list[tuple[float, float, tuple]]:
    """Prune (cost, loss, choice) to the Pareto set: ascending cost,
    strictly descending loss."""
    options.sort(key=lambda o: (o[0], o[1]))
    out: list[tuple[float, float, tuple]] = []
    best = float("inf")
    for c, l, choice in options:
        if l < best:
            out.append((c, l, choice))
            best = l
    return out


def _component_options(comp: list[Hashable], members: Mapping[Hashable, list[str]],
                       group_of: Mapping[str, Hashable], sens: SensTable,
                       costs, bit_choices: Sequence[int]
                       ) -> list[tuple[float, float, tuple]]:
    """Enumerate one component's joint assignments -> Pareto options.

    Option choice payload is the per-group bits tuple (aligned with
    ``comp`` order).
    """
    n_joint = len(bit_choices) ** len(comp)
    if n_joint > MAX_COMPONENT_ENUM:
        raise ValueError(
            f"component of {len(comp)} coupled groups needs {n_joint} joint "
            f"evaluations (> {MAX_COMPONENT_ENUM}); tie more paths via "
            f"`groups` or use method='lagrange'")
    in_comp = {p for g in comp for p in members[g]}
    pairs = [(p1, p2, v) for (p1, p2), v in sens.offdiag.items()
             if p1 in in_comp and p2 in in_comp]
    options = []
    for bits_tuple in itertools.product(bit_choices, repeat=len(comp)):
        of = dict(zip(comp, bits_tuple))
        loss = 0.0
        cost = 0.0
        for g in comp:
            b = of[g]
            for p in members[g]:
                loss += sens.diag.get((p, b), 0.0)
                cost += costs(p, b)
        for p1, p2, v in pairs:
            if of[group_of[p1]] == 2 and of[group_of[p2]] == 2:
                loss += v
        options.append((cost, loss, bits_tuple))
    return _pareto(options)


def solve_budget(sens: SensTable, cost_table, budget: float, *,
                 groups: Optional[Mapping[str, Hashable]] = None,
                 bit_choices: Sequence[int] = BIT_CHOICES,
                 method: str = "exact") -> BudgetSolution:
    """Minimize predicted loss subject to ``cost(assign) <= budget``.

    Args:
      sens: sensitivity lookup table; its ``shapes`` keys define the
        assignment domain.
      cost_table: a :class:`.cost.CostTable` (or anything with a
        ``cost(path, bits)`` method and a ``kind`` attribute).
      budget: inclusive upper bound in the cost table's unit.
      groups: optional path -> key map; paths sharing a key are
        constrained to the same bits (storage stacks — see
        :func:`.apply.storage_groups`).
      bit_choices: candidate widths per path (default ``{2, 4, 8}``).
      method: ``'exact'`` (Pareto-merge DP, default) or ``'lagrange'``
        (approximate multiplier bisection for very large instances).

    Returns:
      :class:`BudgetSolution`; ``predicted_loss``/``cost`` are recomputed
      from the returned assignment via the shared
      :func:`~repro_torch.core.mixed_precision.fitness` objective.

    Raises:
      BudgetInfeasibleError: when even the cheapest assignment exceeds
        the budget.
    """
    paths = sorted(sens.shapes)
    if not paths:
        raise ValueError("sensitivity table has an empty domain")
    group_of = _normalize_groups(paths, groups)
    members: dict[Hashable, list[str]] = {}
    for p in paths:
        members.setdefault(group_of[p], []).append(p)

    costs = cost_table.cost
    dom_pairs = [(p1, p2) for (p1, p2) in sens.offdiag
                 if p1 in group_of and p2 in group_of]
    comps = _components(paths, group_of, dom_pairs)
    per_comp = [_component_options(c, members, group_of, sens, costs,
                                   bit_choices) for c in comps]

    min_cost = sum(min(o[0] for o in opts) for opts in per_comp)
    if min_cost > budget:
        raise BudgetInfeasibleError(
            f"budget {budget:g} ({cost_table.kind}) is below the cheapest "
            f"feasible assignment ({min_cost:g})")

    if method == "lagrange":
        choice = _lagrange(per_comp, budget)
    elif method == "exact":
        choice = _pareto_merge(per_comp, budget)
    else:
        raise ValueError(f"unknown method {method!r} (exact | lagrange)")

    assign: dict[str, int] = {}
    n_frontier = choice.pop("n_frontier")
    for comp, bits_tuple in zip(comps, choice["bits"]):
        for g, b in zip(comp, bits_tuple):
            for p in members[g]:
                assign[p] = b
    loss = fitness(sens, assign)
    cost = sum(costs(p, b) for p, b in assign.items())
    return BudgetSolution(assign=assign, predicted_loss=loss, cost=cost,
                          budget=budget, kind=cost_table.kind, method=method,
                          n_frontier=n_frontier)


def _pareto_merge(per_comp: list[list[tuple[float, float, tuple]]],
                  budget: float) -> dict:
    """Exact DP: fold component Pareto sets into one frontier of sums."""
    # cheapest completion of components [i:] — lets the merge prune
    # partial sums that can no longer fit the budget
    min_tail = [0.0] * (len(per_comp) + 1)
    for i in range(len(per_comp) - 1, -1, -1):
        min_tail[i] = min_tail[i + 1] + min(o[0] for o in per_comp[i])

    frontier: list[tuple[float, float, tuple]] = [(0.0, 0.0, ())]
    for i, opts in enumerate(per_comp):
        merged = [(c0 + c, l0 + l, ch0 + (ch,))
                  for c0, l0, ch0 in frontier
                  for c, l, ch in opts
                  if c0 + c + min_tail[i + 1] <= budget]
        frontier = _pareto(merged)
    best = min(frontier, key=lambda o: o[1])
    return {"bits": best[2], "n_frontier": len(frontier)}


def _lagrange(per_comp: list[list[tuple[float, float, tuple]]],
              budget: float, iters: int = 64) -> dict:
    """Bisect the multiplier of ``loss + lam * cost``; keep the best
    feasible point seen. Returns a convex-hull point (approximate)."""

    def pick(lam: float):
        total_c = total_l = 0.0
        bits = []
        for opts in per_comp:
            c, l, ch = min(opts, key=lambda o: o[1] + lam * o[0])
            total_c += c
            total_l += l
            bits.append(ch)
        return total_c, total_l, tuple(bits)

    best = None
    lo, hi = 0.0, 1.0
    c, l, ch = pick(0.0)
    if c <= budget:
        return {"bits": ch, "n_frontier": 1}
    while pick(hi)[0] > budget:
        hi *= 2.0
        if hi > 1e18:
            break
    for _ in range(iters):
        lam = 0.5 * (lo + hi)
        c, l, ch = pick(lam)
        if c <= budget:
            if best is None or l < best[1]:
                best = (c, l, ch)
            hi = lam
        else:
            lo = lam
    if best is None:  # fall back to the cheapest assignment
        best = pick(hi)
    return {"bits": best[2], "n_frontier": 1}


def grouped_problem(sens: SensTable, cost_table, groups: Mapping[str, Hashable],
                    *, bit_choices: Sequence[int] = BIT_CHOICES):
    """Collapse (sens, cost) to one path per group — the search space
    tied paths actually span.

    Cross-checking searchers without group support (``genetic_search``)
    against a group-constrained :func:`solve_budget` run is only fair on
    the same space: an untied GA can report per-layer splits inside a
    storage stack that container promotion cannot ship, "beating" the
    solver with fictitious points. Returns ``(gsens, gcost, expand)``:
    group-level tables whose fitness/cost equal the full problem's under
    the tie (intra-group 2-bit pairs fold into the group's 2-bit
    diagonal), and ``expand`` mapping a group assignment back to
    per-path bits.
    """
    from .cost import CostTable

    paths = sorted(sens.shapes)
    group_of = _normalize_groups(paths, groups)
    members: dict[Hashable, list[str]] = {}
    for p in paths:
        members.setdefault(group_of[p], []).append(p)
    names = {g: g if isinstance(g, str) else "/".join(map(str, g))
             if isinstance(g, tuple) else str(g) for g in members}
    if len(set(names.values())) != len(names):
        raise ValueError("group keys collide after string rendering")

    gdiag: dict[tuple[str, int], float] = {}
    goff: dict[tuple[str, str], float] = {}
    for g, mem in members.items():
        for b in bit_choices:
            gdiag[(names[g], b)] = sum(sens.diag.get((p, b), 0.0)
                                       for p in mem)
    for (p1, p2), v in sens.offdiag.items():
        if p1 not in group_of or p2 not in group_of:
            continue
        g1, g2 = group_of[p1], group_of[p2]
        if g1 == g2:
            if 2 in bit_choices:
                gdiag[(names[g1], 2)] += v
        else:
            key = (names[g1], names[g2]) if names[g1] < names[g2] \
                else (names[g2], names[g1])
            goff[key] = goff.get(key, 0.0) + v
    gsens = SensTable(
        diag=gdiag, offdiag=goff,
        block_of={names[g]: min(sens.block_of.get(p, 0) for p in mem)
                  for g, mem in members.items()},
        shapes={names[g]: (len(mem),) + tuple(sens.shapes[mem[0]])
                for g, mem in members.items()})
    gcost = CostTable(
        kind=cost_table.kind,
        backend=getattr(cost_table, "backend", "derived"),
        costs={(names[g], b): sum(cost_table.cost(p, b) for p in mem)
               for g, mem in members.items() for b in bit_choices})

    def expand(gassign: Mapping[str, int]) -> dict[str, int]:
        return {p: gassign[names[group_of[p]]] for p in paths}

    return gsens, gcost, expand


def brute_force(sens: SensTable, cost_table, budget: float, *,
                groups: Optional[Mapping[str, Hashable]] = None,
                bit_choices: Sequence[int] = BIT_CHOICES,
                max_enum: int = MAX_COMPONENT_ENUM) -> BudgetSolution:
    """Full enumeration oracle for :func:`solve_budget` (tests only)."""
    paths = sorted(sens.shapes)
    group_of = _normalize_groups(paths, groups)
    gkeys = list(dict.fromkeys(group_of[p] for p in paths))
    if len(bit_choices) ** len(gkeys) > max_enum:
        raise ValueError(f"brute force over {len(gkeys)} groups is too large")
    best = None
    for bits_tuple in itertools.product(bit_choices, repeat=len(gkeys)):
        of = dict(zip(gkeys, bits_tuple))
        assign = {p: of[group_of[p]] for p in paths}
        cost = sum(cost_table.cost(p, b) for p, b in assign.items())
        if cost > budget:
            continue
        loss = fitness(sens, assign)
        if best is None or loss < best.predicted_loss:
            best = BudgetSolution(assign=assign, predicted_loss=loss,
                                  cost=cost, budget=budget,
                                  kind=cost_table.kind, method="brute")
    if best is None:
        raise BudgetInfeasibleError(
            f"budget {budget:g} ({cost_table.kind}) admits no assignment")
    return best
