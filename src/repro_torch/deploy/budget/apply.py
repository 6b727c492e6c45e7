"""Budget → servable artifact: the deployment half of ``deploy.budget``.

The port of the JAX package's ``repro.deploy.budget.apply``.
:func:`budget_artifact` is the one-call flow behind
``launch/serve.py --budget-bytes/--budget-decode-ms``:

    sens table ──┐
                 ├─ solve_budget ── assign ── rtn_mixed_artifact ── serve
    cost table ──┘

Storage coupling: model bodies store weights as stacks — one leaf per
(sub, module, matrix) holding all layers — and a stacked leaf ships at
the *widest* layer's container (pack.py "container promotion").
Splitting bits inside a stack therefore buys zero bytes and zero kernel
time; :func:`storage_groups` ties each stack's per-layer paths so the
solver only spends budget where the artifact can cash it. Under those
groups every per-(path, bits) cost table is exactly additive.

Bytes accounting: scales, embed/head, norms and fp leaves cost the same
regardless of the assignment, so the fixed overhead is computed once
from a cheapest-assignment probe pack and subtracted from the budget —
the solver then bounds exactly the artifact's variable code bytes, and
``artifact.nbytes() <= budget`` holds by construction.

The calibrated route uses the same assignment: pass
``BudgetSolution.assign`` as ``ReconConfig.per_layer_bits`` and export
the result for BRECQ-quality weights under the same byte/latency bound;
:func:`rtn_mixed_artifact` is the calibration-free fast path. Everything
runs where ``params`` live.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ...core.sensitivity import SensTable
from ...interop import tree_leaves
from ..artifact import (ARTIFACT_SCHEMA_VERSION, ARTIFACT_VERSION,
                        QuantizedArtifact, _deploy_stats)
from ..pack import (EIGHT_BIT_ROOTS, _leaf_plan, pack_codes, rtn_codes,
                    rtn_pack_leaf, tree_bytes)
from .cost import CostTable, bytes_cost_table, measure_cost_table
from .solver import (BIT_CHOICES, BudgetInfeasibleError, BudgetSolution,
                     solve_budget)


def _split_layer(path: str) -> Optional[tuple[tuple, int]]:
    """'body.3/sub0/attn/wq' -> (('body','sub0','attn','wq'), 3); None
    for paths without a layer index (the per-layer ↔ storage-leaf naming
    convention of artifact.export / ReconConfig.per_layer_bits)."""
    parts = path.split("/")
    if "." not in parts[0]:
        return None
    sname, ri = parts[0].rsplit(".", 1)
    if not ri.isdigit():
        return None
    return (sname, *parts[1:]), int(ri)


def storage_groups(paths) -> dict[str, tuple]:
    """path -> storage-stack key: per-layer paths of one stacked leaf
    share a group (same int container on disk and on the device); paths
    without a layer index are their own group."""
    out: dict[str, tuple] = {}
    for p in paths:
        split = _split_layer(p)
        out[p] = split[0] if split is not None else (p,)
    return out


def _stacked_linears(params, n_layers: Optional[int]):
    """Yield ``(keypath, w)`` for every stacked linear in a params tree —
    the mixed-precision assignment domain. The walk reuses
    :func:`~repro_torch.deploy.pack._leaf_plan` (bits value irrelevant
    here) so it can never drift from what RTN packing quantizes;
    embed/head (pinned 8-bit) and the fp router are excluded by it."""

    def walk(node, keypath):
        if not isinstance(node, dict):
            return
        plan = _leaf_plan(node, keypath, 4)
        if plan is None:
            for key, v in node.items():
                yield from walk(v, keypath + (key,))
            return
        kind, _ = plan
        if kind != "linear" or (keypath and keypath[0] in EIGHT_BIT_ROOTS):
            return
        w = node["w"]
        if w.ndim >= 3 and (n_layers is None or w.shape[0] == n_layers):
            yield keypath, w

    yield from walk(params, ())


def weight_shapes(params, n_layers: Optional[int] = None) -> dict[str, tuple]:
    """Per-layer path -> weight shape for every stacked linear — the same
    domain/shape dict a measured :class:`SensTable` carries, so cost
    tables can be built without running a calibration."""
    shapes: dict[str, tuple] = {}
    for keypath, w in _stacked_linears(params, n_layers):
        for i in range(w.shape[0]):
            shapes["/".join((f"{keypath[0]}.{i}", *keypath[1:]))] = \
                tuple(w.shape[1:])
    return shapes


def _rtn_sq_err(w: torch.Tensor, bits: int, group: Optional[int]) -> torch.Tensor:
    """Per-layer Σ(w - RTN(w))² over a stacked leaf (L, …, K, N), with the
    scale divided (not multiplied by its reciprocal), as the JAX
    package's eager proxy computes it."""
    k, n = w.shape[-2], w.shape[-1]
    g = group if (group and k % group == 0) else k
    qmax = 2.0 ** (bits - 1) - 1
    wg = w.to(torch.float32).reshape(*w.shape[:-2], k // g, g, n)
    amax = torch.amax(torch.abs(wg), dim=-2, keepdim=True)
    scale = torch.clamp_min(amax / qmax, 1e-8)
    dq = torch.clamp(torch.round(wg / scale), -(qmax + 1), qmax) * scale
    return torch.sum(((wg - dq) ** 2).reshape(w.shape[0], -1), dim=1)


@torch.no_grad()
def weight_sens_table(params, n_layers: Optional[int] = None, *,
                      bit_choices=BIT_CHOICES,
                      group: Optional[int] = None) -> SensTable:
    """Calibration-free sensitivity proxy: per-layer RTN weight error.

    ``diag[(path, b)]`` is the summed squared round-to-nearest error of
    that layer's weights at ``b`` bits — no Fisher weighting, no block
    propagation, no interactions (``offdiag`` is empty). It is the
    zero-cost stand-in ``serve --budget-*`` uses when no measured table
    (:meth:`SensTable.load`) is supplied. Paths/shapes follow the
    per-layer convention of ``core.sensitivity.measure``
    (``body.{i}/sub0/attn/wq``).
    """
    diag: dict[tuple[str, int], float] = {}
    block_of: dict[str, int] = {}
    shapes: dict[str, tuple] = {}
    for keypath, w in _stacked_linears(params, n_layers):
        errs = {b: _rtn_sq_err(w, b, group).cpu().numpy() for b in bit_choices}
        for i in range(w.shape[0]):
            p = "/".join((f"{keypath[0]}.{i}", *keypath[1:]))
            shapes[p] = tuple(w.shape[1:])
            block_of[p] = i
            for b in bit_choices:
                diag[(p, b)] = float(errs[b][i])
    if not shapes:
        raise ValueError("params tree has no stacked linears to assign "
                         "mixed precision over")
    return SensTable(diag=diag, offdiag={}, block_of=block_of, shapes=shapes)


@torch.no_grad()
def rtn_mixed_artifact(params, assign: dict[str, int], *,
                       group: Optional[int] = None, cfg=None,
                       default_bits: int = 2, kv_dtype: str = "int8",
                       kv_page_size: int = 16) -> QuantizedArtifact:
    """Calibration-free artifact with *per-layer* bits.

    The mixed-precision counterpart of :func:`~repro_torch.deploy.rtn_artifact`:
    ``assign`` maps per-layer paths (``body.{i}/sub0/attn/wq``) to code
    bits; each stack packs every layer's codes at its own width into the
    stack's widest container (the same promotion rule as the calibrated
    ``export``), embed/head stay 8-bit, the router stays fp. Quantizable
    leaves ``assign`` does not cover fall back to ``default_bits`` — keep
    it at the solver's cheapest choice so budget accounting stays exact.
    Scales divide ``amax`` by ``qmax`` (``pack.rtn_codes(divide=True)``),
    as the JAX package's eager packing does, so the artifact's bytes and
    digest equal the JAX package's for the same assignment.
    """
    t0 = time.time()
    stack_assign: dict[tuple, dict[int, int]] = {}
    for p, b in assign.items():
        split = _split_layer(p)
        if split is None:
            raise ValueError(f"assignment path {p!r} has no layer index "
                             f"('body.{{i}}/…' expected)")
        stack_assign.setdefault(split[0], {})[split[1]] = int(b)

    bits_by_path: dict[str, int] = {}
    matched: set[tuple] = set()

    def walk(node, keypath):
        if not isinstance(node, dict):
            return node
        plan = _leaf_plan(node, keypath, default_bits)
        if plan is None:
            return {k: walk(v, keypath + (k,)) for k, v in node.items()}
        kind, b = plan
        out = dict(node)
        if kind == "embed":
            out["table"], out["table_qscale"] = rtn_pack_leaf(
                node["table"], b, None, divide=True)
            bits_by_path["/".join(keypath + ("table",))] = b
            return out
        w = node["w"]
        by_layer = stack_assign.get(keypath)
        if by_layer is None or w.ndim < 3:
            out["w"], out["qscale"] = rtn_pack_leaf(w, b, group, divide=True)
            bits_by_path["/".join(keypath)] = b
            return out
        matched.add(keypath)
        layer_bits = [by_layer.get(i, default_bits) for i in range(w.shape[0])]
        codes, scales = [], []
        for i, lb in enumerate(layer_bits):
            c, s = rtn_codes(w[i], lb, group, divide=True)
            codes.append(c)
            scales.append(s)
        # container promotion: the stack ships at the widest layer's width
        out["w"] = pack_codes(torch.stack(codes), w.shape[-2], max(layer_bits))
        out["qscale"] = torch.stack(scales)
        for i, lb in enumerate(layer_bits):
            bits_by_path["/".join((f"{keypath[0]}.{i}", *keypath[1:]))] = lb
        return out

    packed = walk(params, ())
    unmatched = set(stack_assign) - matched
    if unmatched:
        raise ValueError(
            f"assignment names storage stacks absent from the params tree: "
            f"{sorted('/'.join(k) for k in unmatched)}")
    manifest = {
        "version": ARTIFACT_VERSION,
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "arch": getattr(cfg, "name", None),
        "family": getattr(cfg, "family", None),
        "n_layers": getattr(cfg, "n_layers", None),
        "d_model": getattr(cfg, "d_model", None),
        "vocab": getattr(cfg, "vocab", None),
        "tie_embeddings": getattr(cfg, "tie_embeddings", None),
        "w_group": group, "a_bits": None,
        "kv_dtype": kv_dtype, "kv_page_size": kv_page_size,
        "bits_by_path": bits_by_path,
    }
    artifact = QuantizedArtifact(packed, {}, manifest)
    artifact.stats = _deploy_stats(artifact, tree_bytes(params),
                                   time.time() - t0, bits_by_path)
    return artifact


def budget_artifact(params, sens: SensTable, budget: float, *,
                    kind: str = "bytes", cfg=None,
                    group: Optional[int] = None, method: str = "exact",
                    bit_choices=BIT_CHOICES, m: int = 1,
                    cost_table: Optional[CostTable] = None,
                    kv_dtype: str = "int8", kv_page_size: int = 16
                    ) -> tuple[QuantizedArtifact, BudgetSolution, CostTable]:
    """Budget in, servable artifact out (the ``serve --budget-*`` core).

    Args:
      params: fp params tree of the model to deploy.
      sens: sensitivity table (measured, or :func:`weight_sens_table`).
      budget: ``kind='bytes'``: total artifact bytes (codes + scales +
        embed/head + fp leaves — what :meth:`QuantizedArtifact.nbytes`
        reports); ``kind='decode_ms'``: summed per-layer decode matmul
        time under the measured table (attention/norm time is
        assignment-independent and excluded).
      cost_table: override the default table (analytic bytes table, or a
        freshly measured ``decode_ms`` table at ``m`` rows, timed on the
        device ``params`` live on).
      m: decode activation rows to time for ``kind='decode_ms'``.

    Returns:
      ``(artifact, solution, cost_table)``. The artifact manifest gains
      ``'budget'`` (solution + accounting) and — for measured tables —
      the per-backend ``'cost_tables'`` cache.
    """
    groups = storage_groups(sens.shapes)
    bmin = min(bit_choices)
    all_min = {p: bmin for p in sens.shapes}

    if kind == "bytes":
        table = cost_table or bytes_cost_table(sens.shapes, bit_choices)
        probe = rtn_mixed_artifact(params, all_min, group=group, cfg=cfg,
                                   default_bits=bmin)
        overhead = probe.nbytes() - table.assign_cost(all_min)
        try:
            sol = solve_budget(sens, table, budget - overhead, groups=groups,
                               bit_choices=bit_choices, method=method)
        except BudgetInfeasibleError:
            raise BudgetInfeasibleError(
                f"budget {budget:g} bytes leaves {budget - overhead:g} for "
                f"weight codes after {overhead:g} fixed bytes (scales, "
                f"embed/head, fp leaves) — below the all-{bmin}-bit floor "
                f"of {table.assign_cost(all_min):g}") from None
    elif kind == "decode_ms":
        table = cost_table or measure_cost_table(
            sens.shapes, m=m, bit_choices=bit_choices,
            device=tree_leaves(params)[0].device)
        overhead = 0.0
        sol = solve_budget(sens, table, budget, groups=groups,
                           bit_choices=bit_choices, method=method)
    else:
        raise ValueError(f"unknown budget kind {kind!r} (bytes | decode_ms)")

    art = rtn_mixed_artifact(params, sol.assign, group=group, cfg=cfg,
                             default_bits=bmin, kv_dtype=kv_dtype,
                             kv_page_size=kv_page_size)
    info = sol.to_json()
    # the solution's own budget is the overhead-reduced solver bound;
    # report the user-facing artifact budget as 'budget'
    info.update({"overhead_bytes": overhead, "solver_budget": info["budget"],
                 "budget": budget, "artifact_bytes": art.nbytes()})
    art.manifest["budget"] = info
    if table.kind != "bytes":
        art.manifest.setdefault("cost_tables", {})[table.backend] = \
            table.to_json()
    if kind == "bytes" and art.nbytes() > budget:
        raise AssertionError(
            f"budget accounting drift: artifact is {art.nbytes()} bytes "
            f"against a {budget:g}-byte budget (overhead {overhead:g} + "
            f"solver cost {sol.cost:g})")
    return art, sol, table
