"""The per-layer readers' formulas, one function each. A metric's file
``metrics/<name>.py`` binds one of them as its ``read(run)``; each returns
None where the run gives it nothing to read."""
from __future__ import annotations

from perfbench.work import peaks


def device_idle(run):
    """Device: share of the traced part in which no operation ran on the
    card (``torch.profiler``), in %."""
    tw = run.trace
    if tw is None or tw.window_s <= 0 or not tw.device_events:
        return None
    return 100.0 * (1.0 - tw.busy_s / tw.window_s)


def roofline(run, family: str):
    """Kernels: the summed bound of the family's calls in the traced part
    (``trace.CallBounds``) over the device time of its kernels there, in %."""
    tw, f = run.trace, run.facts
    if tw is None or not f.get(f"{family}_calls"):
        return None
    t, n = tw.family_time_s(family)
    return 100.0 * f[f"{family}_bound_s"] / t if n and t > 0 else None


def tick_ms(run):
    """Scheduler: host clock around every ``ServeEngine.step()`` of the
    window that had work, mean, in ms."""
    ticks = run.facts.get("ticks")
    return sum(ticks) / len(ticks) * 1e3 if ticks else None


def decode_batch(run):
    """Scheduler: slots decoded a decode tick over the window, from the
    engine's counters (``tokens_generated`` and ``decode_ticks`` deltas)."""
    n = run.facts.get("decode_ticks")
    return run.facts["tokens_generated"] / n if n else None


def step_mfu_serve(run):
    """Whole step: the model FLOPs of every token the window served (each
    prefilled and generated token with attention at its context, the head
    only where logits were used; ``work/flops.py``) over the summed wall of
    the ticks times the bf16 dense peak, in %."""
    f, ticks = run.facts.get("model_flops"), run.facts.get("ticks")
    return 100.0 * f / (sum(ticks) * peaks.PEAK_FLOPS) if f and ticks else None


def unit_overhead(run):
    """Calibration entry (``core/reconstruction.py::quantize``): the share
    of the window's wall outside the finished units' optimisation loops, in %."""
    units, w = run.facts.get("units"), run.facts.get("window_s")
    if not units or not w:
        return None
    return 100.0 * (1.0 - sum(u["opt_wall_s"] for u in units) / w)


def opt_iter_ms(run):
    """Unit programs: summed ``opt_wall_s`` over summed ``opt_iters`` of the
    finished units, in ms."""
    units = run.facts.get("units")
    n = sum(u["opt_iters"] for u in units) if units else 0
    return 1e3 * sum(u["opt_wall_s"] for u in units) / n if n else None


def step_mfu_calib(run):
    """Whole step: forward and backward FLOPs of every optimisation
    iteration of the finished units (``work/flops.py::unit_iter_flops``)
    over the window's wall times the bf16 dense peak, in %."""
    f, w = run.facts.get("iter_flops"), run.facts.get("window_s")
    return 100.0 * f / (w * peaks.PEAK_FLOPS) if f and w else None
