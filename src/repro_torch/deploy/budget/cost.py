"""Per-layer deployment cost tables: analytic bytes + measured kernel time.

The port of the JAX package's ``repro.deploy.budget.cost``. The budget
solver consumes a :class:`CostTable` — a per-(path, bits) additive cost
in one unit:

* ``bytes_cost_table`` — physical packed-code bytes, *container-aware*:
  a width that does not pack (W3, or K not divisible by the packing
  factor) is billed at its int8 container, exactly what
  ``deploy.pack.container_bits`` stores.

* ``measure_cost_table`` — the time of each layer's *eligible qmm tiers*
  (the ``decode`` tier, K1 ``qgemv``, and the ``prefill`` tier, K2
  ``qmatmul``, for 2-D nodes at decode row counts; the ``grouped`` tier,
  K3 ``qmatmul_grouped``, for stacked expert nodes), at the layer's real
  (K, N[, E]) shape and container bits. On the card every call launches
  the CUDA kernel, and the calls replay from a CUDA graph between CUDA
  events (the kernels' time, without the eager wrappers' host cost,
  which does not depend on the bits); on CPU tensors the plain tier runs,
  timed by the host clock. The per-(path, bits) cost is the
  best tier's time; the winning tier doubles as a *measured dispatch
  table* (:func:`install_dispatch`) replacing the ``DECODE_M_MAX``
  heuristic.

Measured tables are cached in the artifact manifest per backend (the
device type, ``"cuda"`` or ``"cpu"``; :func:`ensure_cost_table`), so a
served artifact re-times its layers at most once per (backend, decode
batch).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ...device import resolve
from ..pack import container_bits

# decode-region tiers a 2-D packed node can run; 3-D expert stacks only
# ever run the grouped kernel
_DENSE_TIERS = ("decode", "prefill")


@dataclasses.dataclass
class CostTable:
    """Additive per-(path, bits) deployment cost.

    Attributes:
      kind: cost unit — ``'bytes'`` or ``'decode_ms'``.
      backend: ``'analytic'`` or the device type that timed it
        (``'cuda'`` / ``'cpu'``).
      costs: (path, bits) -> cost in ``kind`` units.
      tiers: (path, bits) -> winning qmm tier (measured tables only).
      dispatch: ``"K,N,container_bits"`` -> winning decode-region tier
        (the measured dispatch table, JSON-key friendly).
      meta: provenance (decode rows ``m``, reps, the device's name, every
        unique shape's time per tier…).
    """

    kind: str
    backend: str
    costs: dict[tuple[str, int], float]
    tiers: dict[tuple[str, int], str] = dataclasses.field(default_factory=dict)
    dispatch: dict[str, str] = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def cost(self, path: str, bits: int) -> float:
        try:
            return self.costs[(path, bits)]
        except KeyError:
            raise KeyError(
                f"cost table ({self.kind}, {self.backend}) has no entry for "
                f"({path!r}, {bits}); available bits for known paths: "
                f"{sorted({b for _, b in self.costs})}") from None

    def assign_cost(self, assign: dict[str, int]) -> float:
        """Total cost of an assignment — the solver/GA constraint value."""
        return sum(self.cost(p, b) for p, b in assign.items())

    # -- persistence (manifest / JSON file) -----------------------------------

    def to_json(self) -> dict:
        return {
            "kind": self.kind, "backend": self.backend,
            "costs": [[p, b, c] for (p, b), c in sorted(self.costs.items())],
            "tiers": [[p, b, t] for (p, b), t in sorted(self.tiers.items())],
            "dispatch": dict(self.dispatch), "meta": dict(self.meta),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "CostTable":
        return cls(kind=doc["kind"], backend=doc["backend"],
                   costs={(p, int(b)): float(c) for p, b, c in doc["costs"]},
                   tiers={(p, int(b)): t for p, b, t in doc.get("tiers", [])},
                   dispatch=dict(doc.get("dispatch", {})),
                   meta=dict(doc.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "CostTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


def bytes_cost_table(shapes: dict[str, tuple],
                     bit_choices: Sequence[int] = (2, 4, 8)) -> CostTable:
    """Packed-code bytes per (path, bits), container-aware.

    ``shapes`` maps each path to its per-layer weight shape
    ``(…, K, N)`` (a ``SensTable.shapes`` dict). Scale/embed/norm bytes
    are assignment-independent and excluded — deployment flows account
    for them as a fixed overhead against the total artifact budget.
    """
    costs: dict[tuple[str, int], float] = {}
    for p, shape in shapes.items():
        *lead, k, n = shape
        e = int(np.prod(lead)) if lead else 1
        for b in bit_choices:
            costs[(p, b)] = e * k * n * container_bits(b, k) / 8.0
    return CostTable(kind="bytes", backend="analytic", costs=costs,
                     meta={"container_aware": True})


def _time_calls(fn, x: torch.Tensor, *, inner: int = 8, reps: int = 3,
                warmup: int = 1) -> float:
    """Best-of-``reps`` time of ``inner`` back-to-back calls, in ms/call.

    On the card the ``inner`` calls are captured once in a CUDA graph and
    each rep replays it between two CUDA events, so the time is the
    kernels' own: timed eagerly, a call costs the wrappers' host time
    (tens of µs, whatever the bits), which the kernels' few µs hide under
    and which is the same for every assignment. On the CPU, the host clock
    around ``inner`` plain calls."""
    for _ in range(warmup):
        fn(x)
    best = float("inf")
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn(x)
        graph.replay()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / inner)
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(x)
        best = min(best, (time.perf_counter() - t0) / inner * 1e3)
    return best


@torch.inference_mode()
def measure_cost_table(shapes: dict[str, tuple], *, m: int = 1,
                       bit_choices: Sequence[int] = (2, 4, 8),
                       inner: int = 8, reps: int = 3,
                       seed: int = 0, device=None) -> CostTable:
    """Time every layer's eligible qmm tiers at its real shape and bits.

    Args:
      shapes: path -> per-layer weight shape: ``(K, N)`` dense (runs the
        decode/prefill tiers at ``m`` activation rows) or ``(E, K, N)``
        stacked experts (grouped tier, ``m`` rows per expert).
      m: decode-step activation rows (the serving batch).
      bit_choices: widths to cost; each is timed at its *container*
        width (a W3 or ragged-K layer runs — and is billed — as int8).
      inner/reps: timing loop shape (best-of-reps of inner calls).
      device: where to time (default ``cuda``: the CUDA kernels, replayed
        from a CUDA graph between CUDA events; ``'cpu'``: the plain tiers,
        by the host clock).

    Returns:
      ``CostTable(kind='decode_ms')`` whose per-entry cost is the best
      eligible tier's ms/call and whose ``dispatch`` records the winner
      per (K, N, container) — feed it to :func:`install_dispatch`.

    Unique (shape, container) pairs are timed once and fanned out to all
    paths that share them. An installed dispatch table is set aside while
    timing, so each tier's time is its own kernel's.
    """
    from ...kernels.qmatmul import ops as qmm_ops
    from ...kernels.qmatmul.ops import QuantizedLinear, qmm

    device = resolve(device)
    backend = "cuda" if device.type == "cuda" else "torch"
    rng = np.random.default_rng(seed)
    uniq: dict[tuple, dict] = {}  # (shape, cbits) -> {"ms": …, "tier": …}
    t0 = time.time()

    def timed(shape: tuple, cb: int) -> dict:
        key = (tuple(shape), cb)
        if key in uniq:
            return uniq[key]
        *lead, k, n = shape
        packed_shape = (*lead, k * cb // 8, n)
        packed = torch.from_numpy(
            rng.integers(-128, 128, packed_shape).astype(np.int8)).to(device)
        scales = torch.from_numpy(rng.uniform(
            0.01, 0.1, (*lead, 1, n)).astype(np.float32)).to(device)
        qw = QuantizedLinear(packed, scales, cb, k)
        run = lambda x: qmm(x, qw, backend=backend)  # noqa: E731
        if lead:  # stacked experts: only the grouped tier exists
            x = torch.from_numpy(rng.normal(
                size=(lead[0], m, k)).astype(np.float32)).to(device)
            ms = _time_calls(run, x, inner=inner, reps=reps)
            uniq[key] = {"ms": ms, "tier": "grouped",
                         "per_tier": {"grouped": ms}}
            return uniq[key]
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(device)
        per_tier: dict[str, float] = {}
        for tier in _DENSE_TIERS:
            if tier == "decode" and m > qmm_ops.DECODE_M_MAX:
                continue  # the gemv kernel is a skinny-M specialization
            try:
                qmm_ops.set_decode_tier(tier == "decode")
                per_tier[tier] = _time_calls(run, x, inner=inner, reps=reps)
            finally:
                qmm_ops.set_decode_tier(None)
        tier = min(per_tier, key=per_tier.get)
        uniq[key] = {"ms": per_tier[tier], "tier": tier,
                     "per_tier": per_tier, "k": k, "n": n}
        return uniq[key]

    installed = qmm_ops._DISPATCH_TABLE
    qmm_ops.set_dispatch_table(None)
    try:
        costs: dict[tuple[str, int], float] = {}
        tiers: dict[tuple[str, int], str] = {}
        dispatch: dict[str, str] = {}
        for p, shape in shapes.items():
            k = shape[-2]
            for b in bit_choices:
                cb = container_bits(b, k)
                r = timed(tuple(shape), cb)
                costs[(p, b)] = r["ms"]
                tiers[(p, b)] = r["tier"]
                if "k" in r:  # dense: record the measured dispatch winner
                    dispatch[f"{r['k']},{r['n']},{cb}"] = r["tier"]
    finally:
        qmm_ops.set_dispatch_table(installed)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return CostTable(
        kind="decode_ms", backend=device.type, costs=costs,
        tiers=tiers, dispatch=dispatch,
        meta={"m": m, "inner": inner, "reps": reps, "device_name": name,
              "unique_shapes": len(uniq),
              "timed": [[list(s), cb, r["per_tier"]]
                        for (s, cb), r in uniq.items()],
              "measure_wall_s": round(time.time() - t0, 3)})


def install_dispatch(table: Optional[CostTable]) -> None:
    """Install a measured table's tier winners as the qmm dispatch table.

    ``select_tier`` consults it for decode-shaped 2-D matmuls whenever
    the dispatch mode resolves to ``'measured'`` (automatic once a table
    is installed; ``REPRO_QMM_DISPATCH=heuristic`` opts out). ``None``
    clears the table.
    """
    from ...kernels.qmatmul import ops as qmm_ops

    if table is None:
        qmm_ops.set_dispatch_table(None)
        return
    parsed = {}
    for key, tier in table.dispatch.items():
        k, n, cb = (int(v) for v in key.split(","))
        parsed[(k, n, cb)] = tier
    qmm_ops.set_dispatch_table(parsed)


def ensure_cost_table(artifact, shapes: dict[str, tuple], *, m: int = 1,
                      bit_choices: Sequence[int] = (2, 4, 8),
                      inner: int = 8, reps: int = 3, device=None) -> CostTable:
    """Measured cost table for an artifact, cached in its manifest.

    Looks up ``manifest['cost_tables'][backend]`` (``backend``: the device
    type, ``'cuda'`` by default); a hit with matching decode rows ``m``
    is returned without touching the kernels. Otherwise the layers are
    timed (:func:`measure_cost_table`) and the result is stamped into the
    manifest — re-``save()`` the artifact to persist the cache.
    """
    device = resolve(device)
    backend = device.type
    cached = (artifact.manifest.get("cost_tables") or {}).get(backend)
    if cached is not None and cached.get("meta", {}).get("m") == m:
        return CostTable.from_json(cached)
    table = measure_cost_table(shapes, m=m, bit_choices=bit_choices,
                               inner=inner, reps=reps, device=device)
    artifact.manifest.setdefault("cost_tables", {})[backend] = table.to_json()
    return table
