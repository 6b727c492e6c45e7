"""Calibration inner loop + the structure-keyed unit-program cache.

The port of the JAX package's ``repro.core.calib_loop``. PyTorch runs
eagerly, so a "program" here is a closure over one unit structure: the
cache is keyed by the *structure* of the unit (block stack defs, canonical
quantizer configs, ReconConfig statics, argument shapes and dtypes) —
never by the block index — and counts hits and misses as the JAX cache
does. ``trace_log`` records program builds (there is no tracing).

  * ``scan``: the whole optimization of a unit (minibatch sampling, loss
    and gradients, Adam, the beta schedule), keeping the loss trajectory
    on the device and fetching it once per unit;
  * ``step``: one iteration of the same step, which the ``'python'``
    reference mode drives with a sync per iteration (bit-identical to
    ``scan``: the same operations, only the fetches differ);
  * ``hard``: the hardened forward over the whole calibration set, with
    ``core.adaround.hard_quant`` (K5 on the card);
  * ``fwd``: the FP forward over the whole calibration set.

Minibatch indices come from a ``torch.Generator`` on the streams' device,
seeded per unit from ``(rc.seed, unit index)`` by :func:`unit_generator`:
``jax.random.choice`` cannot be replayed in torch, so a minibatch is the
first ``bs`` entries of a ``randperm``.

Paths are canonical inside a program: block ``j`` of a unit runs under
scope ``u{j}`` whatever its position in the model, so ``body.0/...`` and
``body.5/...`` share one program. Callers translate at the boundary.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import numpy as np
import torch

from ..models.common import NO_QUANT
from ..optim import adam
from . import adaround, lsq
from .hooks import AdaRoundHook, LayerCaptureHook, RecordingHook
from .quantizer import QState

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class UnitPrograms:
    """Entry points for one unit structure. ``model_ref`` is a weakref (the
    cache must not pin models alive, and it guards against id() reuse);
    ``walker_cell`` holds a weakref to the latest Walker, refreshed on
    every fetch."""

    scan: Callable  # the whole loop, one trajectory fetch per unit
    step: Callable  # one iteration (reference / python mode)
    hard: Callable  # hardened forward over the full calib set
    fwd: Callable  # FP forward over the full calib set
    loss: Callable  # the unit loss of one minibatch (what ``step`` differentiates)
    model_ref: Any
    walker_cell: list


@dataclasses.dataclass
class LayerPrograms:
    scan: Callable
    step: Callable


@dataclasses.dataclass
class ProbeProgram:
    """Cached unit probe: the canonical weight paths a unit structure
    touches, in model-traversal order, and an activation capture that runs
    only when ``a_bits`` is set."""

    wpaths: tuple
    acts: Callable  # (bparams, x1, batch1, mem1) -> {cpath: act}
    model_ref: Any
    walker_cell: list


@dataclasses.dataclass
class CaptureProgram:
    """Cached layer-wise input capture: one block under canonical scopes
    with finished paths hard-quantized; returns the target linear's input."""

    run: Callable  # (bparams, states_done, v_done, s_done, x, batch, mem)
    model_ref: Any
    walker_cell: list


_CACHE: dict[tuple, Any] = {}
_TRACE_LOG: list[str] = []  # appended when a program is built
_HITS = {"unit": 0, "layer": 0, "probe": 0, "cap": 0}
_MISSES = {"unit": 0, "layer": 0, "probe": 0, "cap": 0}

# The arguments the scan programs write in place, by position in their
# signatures: (opt, ostate), as the reference declares them donated. The
# program audit (``analysis/audit``) holds the captured programs to them
# (``donation_respected``).
UNIT_DONATE = (2, 3)
LAYER_DONATE = (2, 3)

# Audit capture hook: when a list is installed here, run_unit_loop and
# run_layer_loop append (tag, program, args, walker) for every scan-mode
# call, so the auditor gets the real programs with real arguments without
# re-implementing the calibration plumbing. ``walker`` is the Walker a unit
# program reads through its weakref (None for a layer program), which the
# auditor keeps alive to run the program again. The programs run as before.
AUDIT_CAPTURE: list | None = None


def cache_stats() -> dict:
    return {"unit_hits": _HITS["unit"], "unit_misses": _MISSES["unit"],
            "layer_hits": _HITS["layer"], "layer_misses": _MISSES["layer"],
            "probe_hits": _HITS["probe"], "probe_misses": _MISSES["probe"],
            "cap_hits": _HITS["cap"], "cap_misses": _MISSES["cap"],
            "entries": len(_CACHE), "traces": len(_TRACE_LOG)}


def clear_cache() -> None:
    _CACHE.clear()
    _TRACE_LOG.clear()
    for d in (_HITS, _MISSES):
        for k in d:
            d[k] = 0


def trace_log() -> list[str]:
    return list(_TRACE_LOG)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _flat(t, f"{prefix}[{i}]")
    elif isinstance(tree, QState):
        yield from _flat((tree.scale, tree.zero_point), prefix + ".qs")
    else:
        yield prefix, tree


def _tree_sig(tree) -> tuple:
    """Hashable (paths, shapes, dtypes, devices) signature of a nested
    tree of tensors."""
    return tuple((p, tuple(getattr(t, "shape", ())),
                  str(getattr(t, "dtype", type(t).__name__)),
                  str(getattr(t, "device", "")))
                 for p, t in _flat(tree))


def _rc_sig(rc, bs: int) -> tuple:
    return (rc.iters, bs, rc.lr_v, rc.lr_s, rc.lam, rc.beta,
            rc.input_source, rc.input_mix_prob, rc.a_bits, rc.stream_dtype)


def _sweep_dead() -> None:
    for k in [k for k, v in _CACHE.items()
              if getattr(v, "model_ref", None) is not None
              and v.model_ref() is None]:
        del _CACHE[k]


def _fetch(kind: str, key: tuple, model, walker, build: Callable):
    hit = _CACHE.get(key)
    if hit is not None and (model is None or hit.model_ref() is model):
        if walker is not None:
            hit.walker_cell[0] = weakref.ref(walker)
        _HITS[kind] += 1
        return hit
    _MISSES[kind] += 1
    _sweep_dead()
    progs = _CACHE[key] = build()
    return progs


def unit_generator(seed: int, unit: int, device) -> torch.Generator:
    """The minibatch generator of one unit: a pure function of (seed,
    unit index), so a resumed run draws what an uninterrupted one did."""
    s = int(np.random.SeedSequence([seed, unit]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & ((1 << 63) - 1))


def _apply_blocks(model_ref, walker_cell, stackdefs, rep_bi, hook, bparams,
                  x, batch, mem):
    mdl, wkr = model_ref(), walker_cell[0]()
    # streams may be stored bf16 (ReconConfig.stream_dtype); blocks
    # always compute in f32
    x = x.to(torch.float32)
    mem = mem.to(torch.float32) if mem is not None else None
    ctx = wkr.ctx_for(batch, rep_bi, mem)
    for j, (sd, p_j) in enumerate(zip(stackdefs, bparams)):
        ctx2 = dataclasses.replace(ctx, quant=hook, scope=f"u{j}")
        x, _ = mdl.apply_block(ctx2, sd, p_j, x)
    return x


def _with_grad(opt: dict) -> dict:
    return {k: {p: t.detach().requires_grad_() for p, t in d.items()}
            for k, d in opt.items()}


def _grads_like(opt: dict, loss: torch.Tensor) -> dict:
    leaves = [t for d in opt.values() for t in d.values()]
    gs = iter(torch.autograd.grad(loss, leaves))
    return {k: {p: next(gs) for p in d} for k, d in opt.items()}


# ---------------------------------------------------------------------------
# unit programs (block / stage / net granularity)
# ---------------------------------------------------------------------------


def unit_cache_key(model, stackdefs, is_dec, cfg_items, rc, bs,
                   bparams, states, opt, data) -> tuple:
    return ("unit", id(model), tuple(stackdefs), is_dec, tuple(cfg_items),
            _rc_sig(rc, bs), _tree_sig(bparams),
            _tree_sig(states), _tree_sig(opt), _tree_sig(data))


def get_unit_programs(model, walker, stackdefs, is_dec, cfgs: dict,
                      rc, bs: int, N: int,
                      bparams, states, opt, data) -> UnitPrograms:
    """Fetch (or build) the programs for one unit structure.

    ``cfgs``: canonical path -> QConfig. ``states``/``opt`` are used only
    for their structure in the cache key; ``data`` is the tuple of stream
    tensors the programs will consume."""
    key = unit_cache_key(model, stackdefs, is_dec, sorted(cfgs.items()),
                         rc, bs, bparams, states, opt, data)
    return _fetch("unit", key, model, walker, lambda: _build_unit_programs(
        model, walker, stackdefs, is_dec, cfgs, rc, bs, N))


def _build_unit_programs(model, walker, stackdefs, is_dec, cfgs: dict,
                         rc, bs: int, N: int) -> UnitPrograms:
    _TRACE_LOG.extend(["unit_scan", "unit_step", "unit_hard", "unit_fwd"])
    rep_bi = walker.enc_n if is_dec else 0
    a_bits = rc.a_bits
    lr_ratio = rc.lr_s / rc.lr_v
    acfg = adam.AdamConfig(lr=rc.lr_v)
    sdt = _DTYPES[rc.stream_dtype]  # stream storage dtype; compute is f32
    stackdefs = tuple(stackdefs)
    model_ref = weakref.ref(model)
    walker_cell = [weakref.ref(walker)]

    def apply_unit(hook, bparams, x, batch, mem):
        return _apply_blocks(model_ref, walker_cell, stackdefs, rep_bi, hook,
                             bparams, x, batch, mem)

    def qstates_of(states):
        return {p: (states[p], cfgs[p]) for p in cfgs}

    def unit_loss(opt_, states, bparams, xin, zt, g2b, batch, mem, it):
        hook = AdaRoundHook(qstates_of(states), opt_, a_bits, soft=True)
        x = apply_unit(hook, bparams, xin, batch, mem)
        err = (x - zt).to(torch.float32) ** 2
        if g2b is not None:
            err = err * g2b
        beta, enabled = rc.beta(it, rc.iters)
        reg = sum(adaround.round_reg(v, beta) for v in opt_["v"].values())
        nelem = sum(v.numel() for v in opt_["v"].values())
        return torch.mean(err) + rc.lam * enabled * reg / nelem

    def one_step(opt_, ostate, gen, it, bparams, states, x_q, x_fp, z_fp, g2,
                 batch, mem, lr_scale):
        idx = torch.randperm(N, generator=gen, device=x_q.device)[:bs]
        if rc.input_source == "fp":
            xin = x_fp[idx]
        elif rc.input_source == "mix":
            keep = torch.rand(bs, generator=gen, device=x_q.device) < rc.input_mix_prob
            xin = torch.where(keep[:, None, None], x_fp[idx], x_q[idx])
        else:
            xin = x_q[idx]
        g2b = g2[idx] if g2 is not None else None
        bsl = {k: v[idx] for k, v in batch.items()}
        msl = mem[idx] if mem is not None else None
        # lr_scale is a runtime scalar: guarded retries scale it without
        # building another program
        lr_tree = {"v": {p: lr_scale for p in opt_["v"]},
                   "s": {p: lr_ratio * lr_scale for p in opt_["s"]}}
        og = _with_grad(opt_)
        with torch.enable_grad():
            loss = unit_loss(og, states, bparams, xin, z_fp[idx], g2b, bsl,
                             msl, it)
            grads = _grads_like(og, loss)
        with torch.no_grad():
            opt_, ostate = adam.update(acfg, grads, ostate, opt_, lr_tree)
        return opt_, ostate, loss.detach()

    def scan_program(bparams, states, opt_, ostate, gen,
                     x_q, x_fp, z_fp, g2, batch, mem, lr_scale):
        losses = []
        for it in range(rc.iters):
            opt_, ostate, loss = one_step(opt_, ostate, gen, it, bparams, states,
                                          x_q, x_fp, z_fp, g2, batch, mem,
                                          lr_scale)
            losses.append(loss)
        return opt_, ostate, torch.stack(losses)

    def step_program(bparams, states, opt_, ostate, gen, it,
                     x_q, x_fp, z_fp, g2, batch, mem, lr_scale):
        return one_step(opt_, ostate, gen, it, bparams, states, x_q, x_fp,
                        z_fp, g2, batch, mem, lr_scale)

    @torch.no_grad()
    def hard_program(bparams, states, opt_, x, batch, mem):
        hook = AdaRoundHook(qstates_of(states), opt_, a_bits, soft=False)
        return apply_unit(hook, bparams, x, batch, mem).to(sdt)

    @torch.no_grad()
    def fwd_program(bparams, x, batch, mem):
        return apply_unit(NO_QUANT, bparams, x, batch, mem).to(sdt)

    return UnitPrograms(scan=scan_program, step=step_program,
                        hard=hard_program, fwd=fwd_program, loss=unit_loss,
                        model_ref=model_ref, walker_cell=walker_cell)


def run_unit_loop(progs: UnitPrograms, rc, bparams, states, opt, ostate, gen,
                  x_q, x_fp, z_fp, g2, batch, mem, lr_scale: float = 1.0):
    """Drive the optimization; returns (opt, losses ndarray). ``'scan'``
    fetches the trajectory once; ``'python'`` syncs every iteration.
    ``lr_scale`` multiplies both learning rates (guarded-retry backoff)."""
    lr_scale = torch.tensor(lr_scale, dtype=torch.float32, device=x_q.device)
    if rc.loop_impl == "python":
        losses = []
        for it in range(rc.iters):
            opt, ostate, l = progs.step(bparams, states, opt, ostate, gen, it,
                                        x_q, x_fp, z_fp, g2, batch, mem, lr_scale)
            losses.append(float(l))
        return opt, np.asarray(losses, np.float64)
    if AUDIT_CAPTURE is not None:
        AUDIT_CAPTURE.append(("unit_scan", progs.scan,
                              (bparams, states, opt, ostate, gen, x_q, x_fp, z_fp, g2,
                               batch, mem, lr_scale), progs.walker_cell[0]()))
    opt, ostate, losses = progs.scan(bparams, states, opt, ostate, gen,
                                     x_q, x_fp, z_fp, g2, batch, mem, lr_scale)
    return opt, losses.cpu().numpy()  # the single fetch of the trajectory


# ---------------------------------------------------------------------------
# unit probe cache (weight-path discovery + activation capture)
# ---------------------------------------------------------------------------


def get_unit_probe(model, walker, stackdefs, is_dec, bparams,
                   x1, batch1, mem1) -> ProbeProgram:
    """Fetch (or build) the probe for one unit structure. Building it runs
    the unit once on one sequence under a ``RecordingHook``; returned paths
    are canonical (``u{j}/...``)."""
    stackdefs = tuple(stackdefs)
    key = ("probe", id(model), stackdefs, is_dec,
           _tree_sig((bparams, x1, batch1, mem1)))
    return _fetch("probe", key, model, walker, lambda: _build_unit_probe(
        model, walker, stackdefs, is_dec, bparams, x1, batch1, mem1))


def _build_unit_probe(model, walker, stackdefs, is_dec,
                      bparams, x1, batch1, mem1) -> ProbeProgram:
    _TRACE_LOG.append("unit_probe")
    rep_bi = walker.enc_n if is_dec else 0
    model_ref = weakref.ref(model)
    walker_cell = [weakref.ref(walker)]

    @torch.no_grad()
    def record(bparams, x, batch, mem):
        rec = RecordingHook(capture_acts=True)
        _apply_blocks(model_ref, walker_cell, stackdefs, rep_bi, rec, bparams,
                      x, batch, mem)
        return rec

    wpaths = tuple(record(bparams, x1, batch1, mem1).weights)
    return ProbeProgram(wpaths=wpaths,
                        acts=lambda *a: dict(record(*a).acts),
                        model_ref=model_ref, walker_cell=walker_cell)


# ---------------------------------------------------------------------------
# layer-wise input-capture cache
# ---------------------------------------------------------------------------


def get_capture_program(model, walker, stackdefs, is_dec, target: str,
                        cfg_items, a_bits, rc, data) -> CaptureProgram:
    """Fetch (or build) the capture program for one (block structure,
    target linear, finished-path set) combination. ``cfg_items``:
    (canonical path, QConfig) of the finished paths; ``data`` is the
    argument tuple, used only for its signature."""
    stackdefs = tuple(stackdefs)
    key = ("cap", id(model), stackdefs, is_dec, target, tuple(cfg_items),
           a_bits, rc.stream_dtype, _tree_sig(data))
    return _fetch("cap", key, model, walker, lambda: _build_capture_program(
        model, walker, stackdefs, is_dec, target, dict(cfg_items), a_bits, rc))


def _build_capture_program(model, walker, stackdefs, is_dec, target: str,
                           cfgd: dict, a_bits, rc) -> CaptureProgram:
    _TRACE_LOG.append("layer_cap")
    rep_bi = walker.enc_n if is_dec else 0
    sdt = _DTYPES[rc.stream_dtype]
    model_ref = weakref.ref(model)
    walker_cell = [weakref.ref(walker)]

    @torch.no_grad()
    def cap_program(bparams, states_done, v_done, s_done, x, batch, mem):
        qst = {p: (states_done[p], cfgd[p]) for p in cfgd}
        hook = LayerCaptureHook(qst, v_done, target, s_done, a_bits)
        _apply_blocks(model_ref, walker_cell, stackdefs, rep_bi, hook, bparams,
                      x, batch, mem)
        return hook.captured.to(sdt)

    return CaptureProgram(run=cap_program, model_ref=model_ref,
                          walker_cell=walker_cell)


# ---------------------------------------------------------------------------
# layer programs (per-linear AdaRound baseline)
# ---------------------------------------------------------------------------


def get_layer_programs(qc, rc, bs: int, lead: int, W, st, opt, xin, zt
                       ) -> LayerPrograms:
    key = ("layer", qc, _rc_sig(rc, bs), lead, _tree_sig((W, st, opt, xin, zt)))
    return _fetch("layer", key, None, None,
                  lambda: _build_layer_programs(qc, rc, bs, lead))


def _build_layer_programs(qc, rc, bs: int, lead: int) -> LayerPrograms:
    _TRACE_LOG.extend(["layer_scan", "layer_step"])
    a_bits = rc.a_bits
    acfg = adam.AdamConfig(lr=rc.lr_v)
    lr_ratio = rc.lr_s / rc.lr_v

    def layer_loss(opt_, W, st, xb, zb, it):
        w_q = adaround.soft_quant(W, opt_["v"]["w"], st, qc)
        x = xb.to(torch.float32)  # captures may be stored bf16
        if a_bits is not None:
            x = lsq.lsq_quant(x, opt_["s"]["w"], a_bits, True)
        z = torch.matmul(x, w_q.to(x.dtype))
        beta, enabled = rc.beta(it, rc.iters)
        reg = adaround.round_reg(opt_["v"]["w"], beta)
        return (torch.mean((z - zb).to(torch.float32) ** 2)
                + rc.lam * enabled * reg / opt_["v"]["w"].numel())

    def one_step(opt_, ostate, gen, it, W, st, xin, zt, lr_scale):
        idx = torch.randperm(lead, generator=gen, device=xin.device)[:bs]
        lr_tree = {"v": {"w": lr_scale},
                   "s": {p: lr_ratio * lr_scale for p in opt_["s"]}}
        og = _with_grad(opt_)
        with torch.enable_grad():
            loss = layer_loss(og, W, st, xin[idx], zt[idx], it)
            grads = _grads_like(og, loss)
        with torch.no_grad():
            opt_, ostate = adam.update(acfg, grads, ostate, opt_, lr_tree)
        return opt_, ostate, loss.detach()

    def scan_program(W, st, opt_, ostate, gen, xin, zt, lr_scale):
        losses = []
        for it in range(rc.iters):
            opt_, ostate, loss = one_step(opt_, ostate, gen, it, W, st, xin, zt,
                                          lr_scale)
            losses.append(loss)
        return opt_, ostate, torch.stack(losses)

    def step_program(W, st, opt_, ostate, gen, it, xin, zt, lr_scale):
        return one_step(opt_, ostate, gen, it, W, st, xin, zt, lr_scale)

    return LayerPrograms(scan=scan_program, step=step_program)


def run_layer_loop(progs: LayerPrograms, rc, W, st, opt, ostate, gen, xin, zt,
                   lr_scale: float = 1.0):
    """As :func:`run_unit_loop` for one linear; ``opt`` is {'v': {'w': v},
    's': {'w': s} or {}}."""
    lr_scale = torch.tensor(lr_scale, dtype=torch.float32, device=xin.device)
    if rc.loop_impl == "python":
        losses = []
        for it in range(rc.iters):
            opt, ostate, l = progs.step(W, st, opt, ostate, gen, it, xin, zt,
                                        lr_scale)
            losses.append(float(l))
        return opt, np.asarray(losses, np.float64)
    if AUDIT_CAPTURE is not None:
        AUDIT_CAPTURE.append(("layer_scan", progs.scan,
                              (W, st, opt, ostate, gen, xin, zt, lr_scale), None))
    opt, ostate, losses = progs.scan(W, st, opt, ostate, gen, xin, zt, lr_scale)
    return opt, losses.cpu().numpy()
