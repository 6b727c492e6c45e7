"""Paper Fig. 2: mixed precision Pareto vs unified precision.

The port's counterpart of ``benchmarks/fig2_mixed_precision.py``.
Pipeline exactly as the paper: calibrate unified 2/4/8-bit models once,
tabulate diagonal + intra-block 2-bit pair sensitivities, then sweep
model-size budgets with the genetic algorithm (Algorithm 2) and run the
final block reconstruction at the chosen per-layer bits.

Claim: mixed precision Pareto-dominates the unified-precision points."""
from __future__ import annotations

import time

from repro_torch.core import PTQResult, ReconConfig
from repro_torch.core.evaluate import evaluate
from repro_torch.core.mixed_precision import (GAConfig, H100CostModel,
                                              genetic_search, model_bytes)
from repro_torch.core.sensitivity import SensTable, measure
from repro_torch.deploy.budget import CostTable, measure_cost_table
from repro_torch.device import resolve

from . import common
from .common import RECON_ITERS, cached_brecq, device_arg, emit, get_bench_model


def _per_layer_seconds(cm: H100CostModel, shapes: dict) -> CostTable:
    """``cm``'s latency of each (layer, bits), seconds: its model latency
    is the sum over an assignment's layers."""
    return CostTable(kind="seconds", backend="model", costs={
        (p, b): cm.model_latency_s({p: shapes[p]}, {p: b})
        for p in shapes for b in (2, 4, 8)})


def main(device=None) -> list[dict]:
    dev = resolve(device)
    cfg, model, params, calib, evalb = get_bench_model(device=dev)
    rows = []

    # 1. unified-precision calibrations (reused from table2 cache)
    results = {}
    for b in (2, 4, 8):
        res = cached_brecq(model, params, calib,
                           ReconConfig(w_bits=b, iters=RECON_ITERS),
                           f"t2_brecq_w{b}" if b != 8 else "fig2_brecq_w8")
        results[b] = PTQResult(params_q=res["params_q"],
                               act_scales=res["act_scales"], qstates=res["qstates"],
                               v=res["v"], stats=res["stats"])
        ev = evaluate(model, res["params_q"], evalb)
        rows.append({"name": f"unified_w{b}", "us_per_call": 0,
                     "derived": f"loss={ev['loss']:.4f};bits={b}",
                     "loss": ev["loss"], "bits": float(b)})

    # 2. sensitivity lookup table (diag for 2/4/8 + intra-block 2-bit
    # pairs) — tabulated once and cached as JSON; the budget solver
    # (`serve --budget-bytes --sens`) reloads the same file.
    sens_path = common.ART / "fig2_sens.json"
    if sens_path.exists():
        sens = SensTable.load(sens_path)
        print(f"[fig2] sensitivity table: reloaded {sens_path.name} "
              f"({len(sens.diag)} diag, {len(sens.offdiag)} offdiag)")
    else:
        t0 = time.time()
        sens = measure(model, params, calib[:3], results,
                       bits_options=(2, 4, 8), n_samples=16)
        sens.save(sens_path)
        print(f"[fig2] sensitivity table: {len(sens.diag)} diag, "
              f"{len(sens.offdiag)} offdiag entries in "
              f"{time.time() - t0:.0f}s -> {sens_path.name}")

    # 3. GA sweep over model-size budgets
    full8 = model_bytes(sens.shapes, {p: 8 for p in sens.shapes})
    cost_fn = lambda a: model_bytes(sens.shapes, a)  # noqa: E731
    for frac in (0.35, 0.5, 0.7):
        t0 = time.time()
        assign, info = genetic_search(sens, cost_fn, full8 * frac,
                                      GAConfig(pop_size=50, iters=100))
        ga_s = time.time() - t0
        rc = ReconConfig(w_bits=4, iters=RECON_ITERS, per_layer_bits=assign)
        res = cached_brecq(model, params, calib, rc, f"fig2_mixed_{int(frac*100)}")
        ev = evaluate(model, res["params_q"], evalb)
        avg_bits = 8 * info["cost"] / full8
        rows.append({"name": f"mixed_{int(frac*100)}pct", "us_per_call": ga_s * 1e6,
                     "derived": (f"loss={ev['loss']:.4f};avg_bits={avg_bits:.2f};"
                                 f"fitness={info['fitness']:.4g};ga_s={ga_s:.1f}"),
                     "loss": ev["loss"], "bits": avg_bits})
        print(f"  [mixed_{int(frac*100)}pct] loss {ev['loss']:.4f} "
              f"avg_bits {avg_bits:.2f}")
    # latency-constrained variants: the analytic H100 roofline vs the
    # measured per-layer qmm tier cost (same GA, injected cost fn).
    # Decode-like regime (few tokens/step): the roofline says weight
    # streaming dominates so latency scales with bits; the measured
    # table says what the kernels on *this* device actually do (on the
    # card: K1/K2 replayed from a CUDA graph between CUDA events).
    # Reporting both makes the gap visible.
    mtable = measure_cost_table(sens.shapes, m=8, inner=4, reps=2, device=dev)
    print(f"[fig2] measured cost table on {mtable.meta['device_name']}, ms a call "
          f"per (shape, container bits, tier): {mtable.meta['timed']}")
    variants = [
        ("analytic", H100CostModel(tokens_per_step=32)),
        ("measured", H100CostModel(tokens_per_step=32,
                                   layer_cost_fn=lambda p, s, b:
                                   mtable.cost(p, b) / 1e3)),
    ]
    for tag, cm in variants:
        # the model's per-layer seconds as a table: the GA then falls back
        # to the truly cheapest assignment, not to all-W2 (on the CPU the
        # measured W2 is the slowest, and all-W2 busts the budget)
        lat = _per_layer_seconds(cm, sens.shapes)
        uni = {b: lat.assign_cost({p: b for p in sens.shapes}) for b in (2, 4, 8)}
        # halfway between the cheapest and slowest uniform point — the
        # measured table need not be monotone in bits, so 0.5*lat8 can be
        # infeasible outright
        budget = min(uni.values()) + 0.5 * (max(uni.values()) - min(uni.values()))
        assign, info = genetic_search(sens, lat, budget, GAConfig(iters=100))
        hist = dict(sorted(
            {b: sum(1 for v in assign.values() if v == b)
             for b in set(assign.values())}.items()))
        rc = ReconConfig(w_bits=4, iters=RECON_ITERS, per_layer_bits=assign)
        res = cached_brecq(model, params, calib, rc, f"fig2_mixed_lat50_{tag}")
        ev = evaluate(model, res["params_q"], evalb)
        rows.append({"name": f"mixed_lat50_{tag}", "us_per_call": 0,
                     "derived": (f"loss={ev['loss']:.4f};lat_frac=0.5;"
                                 f"fitness={info['fitness']:.4g};"
                                 f"bits_hist={hist}"),
                     "loss": ev["loss"]})
        print(f"  [mixed_lat50_{tag}] loss {ev['loss']:.4f} bits {hist} "
              f"budget {budget:.3g}s cost {info['cost']:.3g}s; uniform "
              + ", ".join(f"W{b} {v * 1e6:.2f} us" for b, v in uni.items()))
    emit(rows, "fig2")
    return rows


if __name__ == "__main__":
    main(device_arg())
