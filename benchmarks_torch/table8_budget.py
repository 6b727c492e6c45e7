"""Table 8: the budget frontier — exact solver vs unified precision vs GA.

The port's counterpart of ``benchmarks/table8_budget.py``, built on
``repro_torch.deploy.budget``: give the solver any model-bytes budget and
the artifact it ships is at least as good as every unified-precision
artifact that fits the same budget, while the genetic search (paper
Algorithm 2) never beats it under the identical constraint. Sweeps
budgets anchored at the unified W2/W4/W8 artifact sizes (plus midpoints,
where unified precision has no point at all), packs each chosen
assignment into a real artifact, and measures its decode throughput
through the serving harness; a decode-latency sweep against the
*measured* per-layer cost table (K1/K2 replayed from CUDA graphs on the
card, the plain tiers by the host clock on the CPU) rides along.

Writes ``artifacts/bench_torch/BENCH_budget.json`` (``--out`` to
override), never the JAX package's tracked ``BENCH_budget.json``; guarded
by ``scripts/check_budget_bench.py``:
  * every swept budget: ``solver.artifact_bytes <= budget``,
  * every unified point fitting the budget has predicted loss >= the
    solver's,
  * the GA cross-check (on the group-reduced problem, so both searchers
    face the storage-stack tie) never achieves a lower predicted loss.

Model: the reduced serve config by default, as the reference; ``--full``
takes brecq-lm-100m at full width and depth. The calibration-free RTN
weight-error sensitivity proxy by default; ``--sens PATH`` swaps in a
measured ``SensTable`` JSON. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.mixed_precision import GAConfig, fitness, genetic_search
from repro_torch.core.sensitivity import SensTable
from repro_torch.deploy.budget import (budget_artifact, bytes_cost_table,
                                       grouped_problem, measure_cost_table,
                                       rtn_mixed_artifact, storage_groups,
                                       weight_sens_table)
from repro_torch.device import resolve
from repro_torch.launch.serve import run_prefill_decode
from repro_torch.models import get_model

from . import common
from .common import device_name, params_device

ARCH, BATCH, PROMPT, GEN = "brecq_lm_100m", 8, 64, 16


def budget_json() -> Path:
    return common.ART / "BENCH_budget.json"


def _init_params(model, seed: int, device: torch.device):
    """The FP params the bench packs: ``model.init`` from ``seed`` on
    ``device``."""
    return model.init(torch.Generator(device=device).manual_seed(seed))


def _decode_tok_s(model, art, *, batch=BATCH, prompt=PROMPT, gen=GEN,
                  reps=2) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (batch, prompt)).astype(np.int32)
    toks = torch.from_numpy(toks).to(params_device(art.params))
    runs = []
    for _ in range(reps):
        _, s = run_prefill_decode(model, art.params, {"tokens": toks},
                                  batch_size=batch, prompt_len=prompt,
                                  gen_len=gen, hook=art.hook(), quiet=True)
        runs.append(s)
    best = max(runs, key=lambda s: s["tok_s"])
    return {"decode_tok_s": round(best["tok_s"], 1),
            "qmm_tiers": best["qmm_tiers"]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true",
                   help="3-point sweep, 1 serving rep, tiny GA")
    p.add_argument("--sens", default=None,
                   help="measured SensTable JSON; default: RTN weight-error "
                        "proxy (calibration-free)")
    p.add_argument("--out", default=None,
                   help="default: artifacts/bench_torch/BENCH_budget.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true",
                   help="brecq-lm-100m at full width and depth (default: the "
                        "reduced config, as the reference)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve(args.device)
    cfg, model = get_model(ARCH, reduced=not args.full)
    params = _init_params(model, args.seed, dev)
    if args.sens:
        sens = SensTable.load(args.sens)
        sens_source = args.sens
    else:
        sens = weight_sens_table(params, cfg.n_layers)
        sens_source = "rtn_weight_proxy"
    groups = storage_groups(sens.shapes)
    table = bytes_cost_table(sens.shapes)
    # the GA has no group support — cross-check it on the group-reduced
    # problem so it searches the same space the artifact can ship
    gsens, gtable, _ = grouped_problem(sens, table, groups)
    reps = 1 if args.smoke else 2
    ga = GAConfig(pop_size=24, iters=8 if args.smoke else 40, seed=args.seed)

    # unified-precision reference points, through the same artifact path
    unified = {}
    for b in (2, 4, 8):
        art = rtn_mixed_artifact(params, {q: b for q in sens.shapes}, cfg=cfg)
        unified[b] = {
            "bits": b, "artifact_bytes": art.nbytes(),
            "predicted_loss": fitness(sens, {q: b for q in sens.shapes}),
            **_decode_tok_s(model, art, reps=reps),
        }
        print(f"[unified W{b}] {art.nbytes()} bytes, predicted-loss "
              f"{unified[b]['predicted_loss']:.4g}, "
              f"{unified[b]['decode_tok_s']} tok/s decode")

    u2, u4, u8 = (unified[b]["artifact_bytes"] for b in (2, 4, 8))
    budgets = ([u2, (u4 + u8) // 2, u8] if args.smoke
               else [u2, (u2 + u4) // 2, u4, (u4 + u8) // 2, u8])

    rows = []
    for budget in budgets:
        t0 = time.time()
        art, sol, _ = budget_artifact(params, sens, budget, kind="bytes", cfg=cfg)
        solve_s = time.time() - t0
        overhead = art.manifest["budget"]["overhead_bytes"]
        t0 = time.time()
        _, ga_info = genetic_search(gsens, gtable, budget - overhead, ga)
        ga_s = time.time() - t0
        row = {
            "budget_bytes": budget,
            "solver": {"predicted_loss": sol.predicted_loss,
                       "artifact_bytes": art.nbytes(),
                       "bits_histogram": art.manifest["budget"]["bits_histogram"],
                       "n_frontier": sol.n_frontier,
                       "solve_wall_s": round(solve_s, 3),
                       **_decode_tok_s(model, art, reps=reps)},
            "genetic": {"fitness": ga_info["fitness"],
                        "cost": ga_info["cost"],
                        "wall_s": round(ga_s, 3)},
            "dominates_unified": sorted(
                b for b, u in unified.items()
                if u["artifact_bytes"] <= budget
                and sol.predicted_loss <= u["predicted_loss"] + 1e-12
                and art.nbytes() <= u["artifact_bytes"]),
        }
        rows.append(row)
        print(f"[budget {budget}] solver loss {sol.predicted_loss:.4g} "
              f"({art.nbytes()} bytes, {row['solver']['decode_tok_s']} tok/s) "
              f"vs GA {ga_info['fitness']:.4g}; dominates unified "
              f"{row['dominates_unified']}")

    # decode-latency sweep against the measured per-layer tier costs
    mtable = measure_cost_table(sens.shapes, m=min(BATCH, 8),
                                inner=4 if args.smoke else 8, reps=reps, device=dev)
    gsens_m, gmtable, _ = grouped_problem(sens, mtable, groups)
    ms_uniform = {b: mtable.assign_cost({q: b for q in sens.shapes})
                  for b in (2, 4, 8)}
    ms_min = sum(min(mtable.cost(q, b) for b in (2, 4, 8)) for q in sens.shapes)
    # sweep from the cheapest assignment to the slowest uniform point —
    # [ms_min, ms8] alone collapses where 8-bit is fastest
    ms_max = max(ms_uniform.values())
    lat_rows = []
    for frac in ([0.5] if args.smoke else [0.25, 0.5, 1.0]):
        budget_ms = ms_min + frac * (ms_max - ms_min)
        art, sol, _ = budget_artifact(params, sens, budget_ms, kind="decode_ms",
                                      cfg=cfg, cost_table=mtable)
        _, ga_info = genetic_search(gsens_m, gmtable, budget_ms, ga)
        lat_rows.append({
            "budget_decode_ms": round(budget_ms, 4),
            "solver": {"predicted_loss": sol.predicted_loss,
                       "cost_ms": round(sol.cost, 4),
                       "artifact_bytes": art.nbytes(),
                       "bits_histogram": art.manifest["budget"]["bits_histogram"],
                       **_decode_tok_s(model, art, reps=reps)},
            "genetic": {"fitness": ga_info["fitness"],
                        "cost_ms": round(ga_info["cost"], 4)},
        })
        print(f"[budget {budget_ms:.4f}ms] solver loss "
              f"{sol.predicted_loss:.4g} ({sol.cost:.4f}ms) vs GA "
              f"{ga_info['fitness']:.4g} ({ga_info['cost']:.4f}ms)")

    out = {
        "config": {"arch": ARCH, "reduced": not args.full, "batch": BATCH,
                   "prompt_len": PROMPT, "gen_len": GEN,
                   "sens_source": sens_source, "smoke": args.smoke,
                   "backend": dev.type, "device_name": device_name(dev),
                   "n_paths": len(sens.shapes),
                   "n_groups": len(set(groups.values()))},
        "unified": [unified[b] for b in (2, 4, 8)],
        "rows": rows,
        "latency_rows": lat_rows,
        "measured_cost_meta": mtable.meta,
    }
    path = Path(args.out) if args.out is not None else budget_json()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"budget bench -> {path}: {len(rows)} byte budgets, "
          f"{len(lat_rows)} latency budgets")
    return out


if __name__ == "__main__":
    main()
