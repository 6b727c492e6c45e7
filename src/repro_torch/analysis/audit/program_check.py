"""Builders of :class:`AuditProgram` descriptors for the port's real
programs.

The port of the qmm part of the JAX package's
``repro.analysis.audit.program_check``: one program per qmm dispatch tier
(decode ``qgemv``, prefill ``qmatmul``, grouped experts
``qmatmul_grouped``) over real packed nodes, each carrying the
full-dequant f32 shapes of its stacked leaves. On the card the tiers
launch the CUDA kernels; on the CPU they run the plain versions.
"""
from __future__ import annotations

import torch

from .rules import AuditProgram


def forbidden_f32_shapes(params) -> frozenset:
    """Full-dequant f32 shapes for every *stacked* packed leaf in a
    params tree.

    A packed node ``{"w": int8 (..., rows, N), "qscale": ...}`` packs
    ``per`` codes per container row (per in {1, 2, 4} — int8/int4/int2);
    the leaf alone does not reveal ``per``, so every candidate logical
    K = rows * per is forbidden. Only stacked shapes (ndim >= 3) are
    returned: the 2-D per-layer (K, N) unscaled-code materialization is
    a legitimate plain decode step (``qgemv_ref``), while a full
    (E, K, N) / (n, K, N) f32 stack is exactly the residency blowup the
    grouped tier and the stacked layout exist to prevent.
    """
    shapes: set = set()

    def walk(node):
        if not isinstance(node, dict):
            return
        w = node.get("w")
        if w is not None and "qscale" in node and getattr(w, "ndim", 0) >= 3:
            rows, n = w.shape[-2], w.shape[-1]
            for per in (1, 2, 4):
                shapes.add(tuple(w.shape[:-2]) + (rows * per, n))
                if w.ndim >= 4:  # (n_layers, E, rows, N): per-layer slice too
                    shapes.add(tuple(w.shape[1:-2]) + (rows * per, n))
        for v in node.values():
            walk(v)

    walk(params)
    return frozenset(shapes)


QMM_K, QMM_N, QMM_E = 64, 128, 4


def qmm_programs(device, seed: int = 0) -> list[AuditProgram]:
    """One program per qmm dispatch tier (decode gemv / prefill matmul /
    grouped experts) over real W4 nodes on ``device``, at the reference's
    shapes (K 64, N 128, E 4; 4, 32 and 4 x 2 rows)."""
    from ...deploy.pack import rtn_pack_leaf
    from ...kernels.qmatmul.ops import from_node, qmm

    K, N, E = QMM_K, QMM_N, QMM_E
    gen = torch.Generator(device=device).manual_seed(seed)

    def node(*shape):
        w = torch.randn(shape, generator=gen, device=device)
        return dict(zip(("w", "qscale"), rtn_pack_leaf(w, 4, None)))

    node2, node3 = node(K, N), node(E, K, N)

    def tier(x, w, qs):
        return qmm(x, from_node({"w": w, "qscale": qs}, K))

    def prog(name, nd, x):
        return AuditProgram(name=name, fn=tier, args=(x, nd["w"], nd["qscale"]),
                            forbidden_f32=forbidden_f32_shapes({"n": nd}))

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    return [prog("qmm_decode", node2, ones(4, K)),
            prog("qmm_prefill", node2, ones(32, K)),
            prog("qmm_grouped_decode", node3, ones(E, 2, K))]
