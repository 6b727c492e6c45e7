"""Builders of :class:`AuditProgram` descriptors for the port's real
programs.

The port of the JAX package's ``repro.analysis.audit.program_check``.
Every builder returns descriptors for programs the port actually runs,
on an explicit ``device`` (the CUDA kernels on the card, the plain
versions on the CPU): the qmm dispatch tiers, serving decode and prefill
(the launch and engine paths), budget-packed mixed-precision decode, and
the calibration scan programs captured from a micro ``quantize()`` run.
Each carries the invariants past PRs established for it:

* decode-path programs carry ``forbidden_f32``, the full-dequant shapes
  of their stacked packed leaves;
* programs that write an argument in place carry ``donate_argnums``
  (the decode loops' KV caches; the calibration scans' optimizer state,
  as the reference declares it);
* steady-state programs carry ``repeat_args``, so a second,
  same-structure call that plans or builds anything again is caught.

They use the reduced configs and the reference's RTN W4 artifacts, with
weights drawn from explicit ``torch.Generator``s. Prefill programs carry
no ``forbidden_f32``: the grouped plain version dequantizes (E, K, N) per
layer by design at prefill arithmetic intensity. A finding that the port
does not fix yet is in the program's ``suppress``, with its reason.
"""
from __future__ import annotations

import dataclasses

import torch

from ...interop import tree_map
from .rules import AuditProgram, Violation

QUICK_ARCHS = ("brecq_lm_100m", "deepseek_moe_16b")
# Decode-capable archs beyond the quick set, exercised by --configs all.
EXTRA_ARCHS = ("tinyllama_1_1b", "gemma3_12b", "hymba_1_5b")

# The calibration scans' optimizer update is functional, not in place.
CALIB_DONATION = (
    "optim/adam.py:66-73 update() returns new m, v and logits tensors every "
    "iteration (out-of-place mul/add/sub), so the scan's opt and ostate leaves get "
    "new storage at each step (core/calib_loop.py:293 scan_program); in place "
    "(torch._foreach_* into the clone core/reconstruction.py:623 hands each try) "
    "they would keep it, but autograd's gradients stay new tensors of every "
    "leaf's shape (ROADMAP 16)")

# Programs of --configs all whose rule reads a tensor of the state, not a weight.
SERVE_SUPPRESS = {"serve_decode[hymba_1_5b]": {"no_materialized_f32_weight": (
    "models/ssm.py:64-65 (_ssm_coeffs' a and b), :124 (the new state h) and "
    "models/transformer.py:501 (_write_state's copy_) make f32 (B 2, d_inner 128, "
    "d_state 8) tensors, 10 ops a layer, 20 a step, whose shape equals the full "
    "dequant of the reduced config's stacked (n_layers 2, 128, 8) ssm/wB and ssm/wC "
    "leaves: a shape collision at B = n_layers, no dequantized weight (ROADMAP 16)")}}


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
                            repeat_args=(x + 1.0, nd["w"], nd["qscale"]),
                            forbidden_f32=forbidden_f32_shapes({"n": nd}))

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    return [prog("qmm_decode", node2, ones(4, K)),
            prog("qmm_prefill", node2, ones(32, K)),
            prog("qmm_grouped_decode", node3, ones(E, 2, K))]


# ---------------------------------------------------------------------------
# serving: launch-style decode/prefill per arch
# ---------------------------------------------------------------------------


def _rtn_model(arch: str, device):
    """Reduced ``arch`` with weights from a generator seeded 0 on ``device``,
    and its RTN W4 artifact."""
    from ...deploy import rtn_artifact
    from ...models import get_model

    cfg, model = get_model(arch, reduced=True)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return model, rtn_artifact(params, 4, cfg=cfg)


def _copy(tree):
    return tree_map(torch.clone, tree)


def _decode_program(name: str, model, art, device) -> AuditProgram:
    """One cached decode step of a (2, 16) f32 cache at position 4, as
    ``launch/serve.py::run_prefill_decode`` runs it: in place."""
    B, T = 2, 16
    cache = model.init_cache(B, T, torch.float32, device)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos = torch.full((B,), 4, dtype=torch.int32, device=device)
    hook = art.hook()

    @torch.inference_mode()
    def decode(p, t, c, q):
        return model.decode_step(p, t, c, q, hook)

    return AuditProgram(
        name=name, fn=decode, args=(art.params, tok, cache, pos),
        # run_prefill_decode writes the cache in place and takes it back
        donate_argnums=(2,),
        forbidden_f32=forbidden_f32_shapes(art.params),
        repeat_args=(art.params, tok + 1, _copy(cache), pos + 1),
        suppress=dict(SERVE_SUPPRESS.get(name, {})))


def serve_programs(arch: str, device) -> list[AuditProgram]:
    """Decode step (the cache written in place, as ``launch/serve.py``
    writes it) and a prefill program for one reduced arch served from a
    packed RTN W4 artifact on ``device``."""
    model, art = _rtn_model(arch, device)
    cache = model.init_cache(2, 16, torch.float32, device)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=device)
    hook = art.hook()

    @torch.inference_mode()
    def prefill(p, t, c):
        return model.prefill(p, {"tokens": t}, c, hook)

    return [_decode_program(f"serve_decode[{arch}]", model, art, device),
            AuditProgram(name=f"serve_prefill[{arch}]", fn=prefill,
                         args=(art.params, toks, cache))]


# ---------------------------------------------------------------------------
# serving: the continuous-batching engine's two programs
# ---------------------------------------------------------------------------


def engine_programs(arch: str = "brecq_lm_100m", *, device) -> list[AuditProgram]:
    """The ServeEngine's (num_slots, 1) decode and (1, prefill_chunk)
    chunked-prefill programs, the engine's own ``_decode_fn`` and
    ``_chunk_fn``, over its int8 page pool (written in place)."""
    from ...serve_engine import EngineConfig, ServeEngine

    model, art = _rtn_model(arch, device)
    ecfg = EngineConfig(num_slots=2, page_size=8, num_pages=9, max_len=32,
                        prefill_chunk=8)
    eng = ServeEngine(model, art.params, ecfg, quant=art.hook())
    bt = eng._dev(eng.block_tables)
    tok = torch.zeros((ecfg.num_slots, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((ecfg.num_slots,), dtype=torch.int32, device=device)
    tokc = torch.zeros((1, ecfg.prefill_chunk), dtype=torch.int32, device=device)
    return [
        AuditProgram(
            name=f"engine_decode[{arch}]", fn=eng._decode_fn,
            args=(eng.params, tok, eng.cache, pos, bt),
            donate_argnums=(2,),
            forbidden_f32=forbidden_f32_shapes(art.params),
            repeat_args=(eng.params, tok + 1, _copy(eng.cache), pos + 1, bt)),
        AuditProgram(
            name=f"engine_prefill_chunk[{arch}]", fn=eng._chunk_fn,
            args=(eng.params, tokc, _copy(eng.cache), pos[:1], bt[:1])),
    ]


# ---------------------------------------------------------------------------
# budget-packed mixed-precision artifact
# ---------------------------------------------------------------------------


def budget_programs(arch: str = "brecq_lm_100m", *, device) -> list[AuditProgram]:
    """Decode over a budget-style mixed-precision artifact (alternating
    2/4-bit per-layer assignment, containers promoted within stacks), the
    deployment class ``deploy.budget`` produces."""
    from ...deploy.budget import rtn_mixed_artifact, weight_shapes
    from ...models import get_model

    cfg, model = get_model(arch, reduced=True)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    assign = {p: (4 if i % 2 else 2)
              for i, p in enumerate(sorted(weight_shapes(params)))}
    art = rtn_mixed_artifact(params, assign, cfg=cfg)
    return [_decode_program(f"budget_decode[{arch}]", model, art, device)]


# ---------------------------------------------------------------------------
# calibration: the scan programs, captured from a live micro-quantize
# ---------------------------------------------------------------------------


def _pinned(program, keep):
    """``program``, holding ``keep`` (the Walker it reads through a weakref)
    alive for as long as the program is."""
    def run(*args):
        return program(*args)

    run.keep = keep
    return run


def calib_audit(n_layers: int = 2, iters: int = 2, *, device
                ) -> tuple[list[AuditProgram], list[Violation]]:
    """Run a micro ``quantize()`` on ``device`` with
    ``calib_loop.AUDIT_CAPTURE`` installed and return

    * AuditPrograms for the captured scan programs, with the arguments
      ``calib_loop`` declares written in place (``UNIT_DONATE``,
      ``LAYER_DONATE``), and
    * unit-cache violations: with ``n_layers`` identical transformer blocks
      the unit program must be built once and reused (``unit_hits >=
      n_layers - 1``); fewer hits means the cache key broke and every block
      of a real run would build its programs again.
    """
    from ...core import ReconConfig, calib_loop, quantize
    from ...data import Corpus, CorpusConfig, make_batches
    from ...models import build_model, get_config

    cfg = dataclasses.replace(get_config("brecq_lm_100m", reduced=True),
                              n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    calib = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1)

    calib_loop.clear_cache()
    captured: list = []
    calib_loop.AUDIT_CAPTURE = captured
    try:
        quantize(model, params, calib,
                 ReconConfig(w_bits=4, iters=iters, calib_bs=4, seed=0))
    finally:
        calib_loop.AUDIT_CAPTURE = None
    stats = calib_loop.cache_stats()

    donate = {"unit_scan": calib_loop.UNIT_DONATE,
              "layer_scan": calib_loop.LAYER_DONATE}
    programs, seen = [], set()
    for tag, program, args, walker in captured:
        if tag in seen:
            continue
        seen.add(tag)
        programs.append(AuditProgram(
            name=f"calib_{tag}", fn=_pinned(program, walker), args=args,
            donate_argnums=donate[tag],
            suppress={"donation_respected": CALIB_DONATION}))

    violations = []
    if not captured:
        violations.append(Violation(
            "stable_compile_cache", "calib_unit_scan",
            "micro-quantize captured no scan programs (AUDIT_CAPTURE hook "
            "broken or unit loop bypassed)"))
    elif stats["unit_hits"] < n_layers - 1:
        violations.append(Violation(
            "stable_compile_cache", "calib_unit_scan",
            f"{n_layers} identical blocks produced only "
            f"{stats['unit_hits']} unit-program cache hit(s) "
            f"(misses={stats['unit_misses']}): the unit program cache key "
            f"no longer keys on structure and real runs would rebuild per block"))
    return programs, violations


# ---------------------------------------------------------------------------
# the default program set
# ---------------------------------------------------------------------------


def build_programs(configs: str = "quick", *, with_calib: bool = True, device=None
                   ) -> tuple[list[AuditProgram], list[Violation]]:
    """All audited programs for a config scope on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``), plus any
    violations the builders detect directly (calibration cache hits)."""
    from ...device import resolve

    device = resolve(device)
    archs = QUICK_ARCHS if configs == "quick" else QUICK_ARCHS + EXTRA_ARCHS
    programs: list[AuditProgram] = []
    violations: list[Violation] = []
    programs += qmm_programs(device)
    for arch in archs:
        programs += serve_programs(arch, device)
    programs += engine_programs(device=device)
    programs += budget_programs(device=device)
    if with_calib:
        calib_progs, calib_viol = calib_audit(device=device)
        programs += calib_progs
        violations += calib_viol
    return programs, violations
