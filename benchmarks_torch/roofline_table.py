"""Roofline table from the port's dry-run artifacts.

The port of the reference's ``benchmarks/roofline_table.py``. Reads
``artifacts/dryrun_torch/*.json`` (written by ``repro_torch.launch.dryrun``)
and prints the per-(arch x shape x mesh) three-term table on one H100 with
the bottleneck and a fix hint, then one ``name,us,derived`` CSV row a cell.
Run it after ``python -m repro_torch.launch.dryrun --all``:

    PYTHONPATH=src python -m benchmarks_torch.roofline_table
"""
from __future__ import annotations

import json
from pathlib import Path

ART = Path(__file__).resolve().parents[1] / "artifacts" / "dryrun_torch"

FIX_HINTS = {
    "compute": "increase arithmetic intensity (fuse, larger per-GPU batch)",
    "memory": "cut HBM traffic: quantized weights/KV, better remat policy",
    "collective": "reshard: keep TP all-reduces and EP all-to-alls on NVLink, "
                  "fewer InfiniBand crossings, overlap with compute",
}


def load_rows(art: Path = ART) -> list[dict]:
    rows = []
    for f in sorted(Path(art).glob("*.json")):
        d = json.loads(f.read_text())
        if d.get("tag"):
            continue  # variants are reported in PERF.md, not the baseline table
        r = d["roofline"]
        rows.append({
            "arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
            "strategy": d["strategy"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
            "model_flops": r["model_flops_per_chip"],
            "trace_flops": r["hlo_flops_per_chip"],
            "useful_ratio": r["useful_ratio"], "roofline_frac": r["roofline_frac"],
            "fits_80gb": d.get("fits_80gb"),
            "per_chip_gb": d.get("per_chip_bytes", 0) / 1e9,
            "fix": FIX_HINTS[r["bottleneck"]],
        })
    return rows


def main(art: Path = ART) -> list[dict]:
    rows = load_rows(art)
    if not rows:
        print("roofline/none,0,run `python -m repro_torch.launch.dryrun --all` first")
        return []
    print(f"{'arch':24s} {'shape':12s} {'mesh':6s} {'strat':6s} "
          f"{'compute':>9s} {'memory':>9s} {'collect':>9s} {'bound':>10s} "
          f"{'useful':>7s} {'frac':>6s} {'GB/GPU':>8s} fit")
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} {r['strategy']:6s} "
              f"{r['compute_s']:9.4f} {r['memory_s']:9.4f} {r['collective_s']:9.4f} "
              f"{r['bottleneck']:>10s} {r['useful_ratio']:7.3f} "
              f"{r['roofline_frac']:6.3f} {r['per_chip_gb']:8.1f} "
              f"{'Y' if r['fits_80gb'] else 'N'}")
    for r in rows:
        print(f"roofline/{r['arch']}_{r['shape']}_{r['mesh']},"
              f"{max(r['compute_s'], r['memory_s'], r['collective_s']) * 1e6:.0f},"
              f"bound={r['bottleneck']};frac={r['roofline_frac']:.3f}")
    return rows


if __name__ == "__main__":
    main()
