"""Table 5 (repo extension): calibration-loop throughput before/after.

The port's counterpart of ``benchmarks/table5_calib_speed.py``. BRECQ's
practical pitch is cheap calibration, so the loop's iterations per second
is the headline systems metric. For each reconstruction granularity we
run the same quantization twice:

  * ``python``  — one step per iteration, a host-side loss sync every
    iteration (the reference mode);
  * ``scan``    — the whole unit's optimization in one call, the loss
    trajectory fetched once per unit, the unit-program cache across
    identical blocks.

Both run the identical step body, so the loss trajectories match and the
delta is dispatch/sync overhead. The program cache is cleared before each
run, so building the programs counts; the port's Fisher builds no
programs and keeps no cache.
"""
from __future__ import annotations

import time

from repro_torch.core import ReconConfig, quantize
from repro_torch.core.calib_loop import clear_cache
from repro_torch.device import resolve

from .common import RECON_ITERS, device_arg, emit, get_bench_model, synchronize

W_BITS = 4
GRANULARITIES = ("layer", "block", "stage", "net")


def main(device=None) -> list[dict]:
    dev = resolve(device)
    cfg, model, params, calib, _evalb = get_bench_model(device=dev)
    rows = []
    for gran in GRANULARITIES:
        ips = {}
        for impl in ("python", "scan"):
            clear_cache()  # cold-start both impls: building programs counts
            rc = ReconConfig(w_bits=W_BITS, iters=RECON_ITERS,
                             granularity=gran, use_fisher=(gran != "layer"),
                             loop_impl=impl)
            synchronize(dev)
            t0 = time.time()
            res = quantize(model, params, calib, rc)
            synchronize(dev)
            wall = time.time() - t0
            ips[impl] = res.stats["calib_iters_per_s"]
            cache = res.stats["unit_cache"]
            mem = res.stats["calib_peak_bytes_detail"]
            rows.append({
                "name": f"{gran}_{impl}",
                "us_per_call": wall * 1e6,
                "derived": (f"calib_iters_per_s={ips[impl]:.1f};"
                            f"wall_s={res.stats['calib_wall_s']:.1f};"
                            f"fisher_wall_s={res.stats['fisher_wall_s']:.1f};"
                            f"peak_mb={res.stats['calib_peak_bytes'] / 1e6:.1f};"
                            f"fisher_mb={mem['fisher'] / 1e6:.1f};"
                            f"cache_hits={cache['hits']};"
                            f"cache_misses={cache['misses']}"),
                "calib_iters_per_s": ips[impl],
                "calib_peak_bytes": res.stats["calib_peak_bytes"],
            })
        rows.append({
            "name": f"{gran}_speedup", "us_per_call": 0,
            "derived": f"scan/python={ips['scan'] / max(ips['python'], 1e-9):.1f}x",
        })
    emit(rows, "table5")
    return rows


if __name__ == "__main__":
    main(device_arg())
