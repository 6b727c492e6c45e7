"""Genetic-algorithm mixed precision under a hardware constraint
(paper Sec. 3.4 + Algorithm 2), with an analytic H100 cost model.

The port of the JAX package's ``repro.core.mixed_precision`` (pure numpy:
the same RNG calls in the same order, so a seed gives the same assignment
and history in both packages).

Search space c in {2,4,8}^n. Fitness = sum of diagonal sensitivities at
the assigned bits + intra-block pairwise interaction for layers assigned
2-bit. Constraint H(c) <= delta where H is model bytes or estimated
serving latency.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .sensitivity import SensTable

BIT_CHOICES = (2, 4, 8)


# ---------------------------------------------------------------------------
# H100 cost model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class H100CostModel:
    """Analytic roofline for per-layer serving cost on an H100 SXM.

    The fields and formula of the JAX package's ``TPUCostModel``; the
    defaults are the H100 SXM data-sheet peaks (dense bf16 on the tensor
    cores, HBM3 bandwidth) of an ``NVIDIA H100 80GB HBM3`` at its 700 W
    limit. Weight-only quantization leaves the matmul FLOPs unchanged
    (dequant before the multiply); the win is the weight-streaming memory
    term, which scales linearly with bits. int8 activations double the
    tensor cores' throughput.

    ``layer_cost_fn`` swaps the roofline for an injected per-layer cost
    ``(path, shape, w_bits) -> seconds``, e.g. measured kernel times
    (``repro_torch.deploy.budget.cost.measure_cost_table``).
    """

    peak_flops_bf16: float = 989e12
    hbm_bw: float = 3.35e12
    tokens_per_step: int = 1024  # batch x seq of the serving shape
    layer_cost_fn: Optional[Callable[[str, tuple, int], float]] = None

    def layer_latency_s(self, shape: tuple, w_bits: int, a_bits: int = 16) -> float:
        *lead, k, n = shape
        e = int(np.prod(lead)) if lead else 1  # stacked experts
        flops = 2.0 * self.tokens_per_step * k * n  # per expert-equivalent
        peak = self.peak_flops_bf16 * (2.0 if a_bits <= 8 else 1.0)
        compute_t = e * flops / peak
        w_bytes = e * k * n * w_bits / 8.0
        act_bytes = self.tokens_per_step * (k + n) * (a_bits / 8.0)
        mem_t = (w_bytes + act_bytes) / self.hbm_bw
        return max(compute_t, mem_t)

    def model_latency_s(self, shapes: dict[str, tuple], bits: dict[str, int],
                        a_bits: int = 16) -> float:
        if self.layer_cost_fn is not None:
            return sum(self.layer_cost_fn(p, shapes[p], bits[p])
                       for p in shapes)
        return sum(self.layer_latency_s(shapes[p], bits[p], a_bits) for p in shapes)


def model_bytes(shapes: dict[str, tuple], bits: dict[str, int]) -> float:
    return sum(np.prod(s) * bits[p] / 8.0 for p, s in shapes.items())


# ---------------------------------------------------------------------------
# fitness from the sensitivity lookup table
# ---------------------------------------------------------------------------


def fitness(sens: SensTable, assign: dict[str, int]) -> float:
    total = 0.0
    for p, b in assign.items():
        total += sens.diag.get((p, b), 0.0)
    for (p1, p2), inter in sens.offdiag.items():
        if assign.get(p1) == 2 and assign.get(p2) == 2:
            total += inter
    return total


# ---------------------------------------------------------------------------
# genetic algorithm (paper Algorithm 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GAConfig:
    pop_size: int = 50
    iters: int = 100
    p_mutation: float = 0.1
    top_k: int = 10
    seed: int = 0
    max_tries: int = 200  # per half-population fill


def genetic_search(sens: SensTable, cost_fn: Callable[[dict[str, int]], float],
                   delta: float, ga: GAConfig = GAConfig()) -> tuple[dict[str, int], dict]:
    """Search argmin fitness s.t. cost_fn(assign) <= delta.

    ``cost_fn`` is a whole-assignment cost; a per-layer
    ``deploy.budget.CostTable`` may be passed directly (its
    ``assign_cost`` is used), so the GA and the exact solver run under
    identical constraints. With a per-layer table the infeasibility
    fallback is the true cheapest assignment (measured tables need not be
    monotone in bits)."""
    per_layer = cost_fn if hasattr(cost_fn, "assign_cost") else None
    cost_fn = getattr(cost_fn, "assign_cost", cost_fn)
    paths = sorted(sens.shapes.keys())
    n = len(paths)
    rng = np.random.default_rng(ga.seed)
    if per_layer is None:
        cheapest = np.zeros(n, np.int64)  # all 2-bit
    else:
        cheapest = np.array([min(range(len(BIT_CHOICES)), key=lambda i:
                                 per_layer.cost(p, BIT_CHOICES[i]))
                             for p in paths], np.int64)

    def to_assign(vec: np.ndarray) -> dict[str, int]:
        return {p: BIT_CHOICES[v] for p, v in zip(paths, vec)}

    def feasible(vec) -> bool:
        return cost_fn(to_assign(vec)) <= delta

    def random_vec() -> np.ndarray:
        # gaussian around mid-precision, rounded into {0,1,2} (paper init)
        return np.clip(np.round(rng.normal(1.0, 0.8, n)), 0, 2).astype(np.int64)

    # initial feasible population (bias toward low bits if delta is tight)
    pop: list[np.ndarray] = []
    tries = 0
    while len(pop) < ga.pop_size and tries < ga.max_tries * ga.pop_size:
        v = random_vec()
        if not feasible(v):
            v = cheapest.copy()
            if not feasible(v):
                raise ValueError("delta infeasible even at the cheapest "
                                 "assignment")
        pop.append(v)
        tries += 1

    def score(v) -> float:
        return fitness(sens, to_assign(v))

    topk: list[tuple[float, np.ndarray]] = []
    history = []
    for _t in range(ga.iters):
        scored = sorted(((score(v), v) for v in pop), key=lambda x: x[0])
        pool = scored[: ga.top_k] + topk
        pool = sorted(pool, key=lambda x: x[0])[: ga.top_k]
        topk = [(s, v.copy()) for s, v in pool]
        history.append(topk[0][0])

        def crossover() -> np.ndarray:
            a = topk[rng.integers(len(topk))][1]
            b = topk[rng.integers(len(topk))][1]
            mask = rng.random(n) < 0.5
            return np.where(mask, a, b)

        def mutate() -> np.ndarray:
            v = topk[rng.integers(len(topk))][1].copy()
            mask = rng.random(n) < ga.p_mutation
            v[mask] = rng.integers(0, 3, mask.sum())
            return v

        new_pop: list[np.ndarray] = []
        for gen in (crossover, mutate):
            half: list[np.ndarray] = []
            tries = 0
            while len(half) < ga.pop_size // 2 and tries < ga.max_tries:
                c = gen()
                tries += 1
                if feasible(c):
                    half.append(c)
            while len(half) < ga.pop_size // 2:  # fall back to known-feasible
                half.append(topk[rng.integers(len(topk))][1].copy())
            new_pop += half
        pop = new_pop

    best_s, best_v = topk[0]
    assign = to_assign(best_v)
    return assign, {"fitness": best_s, "history": history,
                    "cost": cost_fn(assign)}


def pareto_sweep(sens: SensTable, cost_fn, deltas, ga: GAConfig = GAConfig()):
    """One GA run per threshold -> (delta, assignment, fitness) Pareto set."""
    out = []
    for d in deltas:
        assign, info = genetic_search(sens, cost_fn, d, ga)
        out.append({"delta": d, "assign": assign, **info})
    return out
