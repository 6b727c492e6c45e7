"""Benchmark entry point of the port: one function per paper table/figure.

Prints ``name,us_per_call,derived`` CSV rows per table (scaffold
contract) and saves JSON artifacts under ``artifacts/bench_torch/``;
after each table, the launches of the hand-written kernels it made
(``fakequant`` in the hardened forwards and ``bake``; ``qgemv`` and
``qmatmul`` in table 6's serving and fig2's measured cost table). Runs on
the card; ``--device cpu`` runs every table on the host's plain paths.

As the reference's ``run.py``, it runs neither table 7 nor table 8: they
are ``python -m benchmarks_torch.table7_serve_mt`` and ``python -m
benchmarks_torch.table8_budget``.

    PYTHONPATH=src python -m benchmarks_torch.run [TABLE ...] [--device cpu]
"""
from __future__ import annotations

import sys
import time


def _kernels() -> tuple:
    """The kernel modules whose launches the tables report."""
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.qmatmul import kernel as qm_kernel

    return fq_kernel, qm_kernel


def main(argv=None) -> None:
    from . import (fig2_mixed_precision, roofline_table, table1_granularity,
                   table2_weight_only, table3_full_quant, table4_cost,
                   table5_calib_speed, table6_deploy)
    from .common import device_arg

    argv = sys.argv[1:] if argv is None else list(argv)
    device = device_arg(argv)
    if device is not None:
        i = argv.index("--device")
        del argv[i:i + 2]
    tables = [
        # instant: reads launch/dryrun.py's artifacts, no device work
        ("roofline_table", lambda device: roofline_table.main()),
        ("table1_granularity", table1_granularity.main),
        ("table2_weight_only", table2_weight_only.main),
        ("table3_full_quant", table3_full_quant.main),
        ("table4_cost", table4_cost.main),
        ("table5_calib_speed", table5_calib_speed.main),
        ("table6_deploy", table6_deploy.main),
        ("fig2_mixed_precision", fig2_mixed_precision.main),
    ]
    only = argv or None
    for name, fn in tables:
        if only and name not in only:
            continue
        print(f"\n===== {name} =====")
        for k in _kernels():
            k.reset_launches()
        t0 = time.time()
        try:
            fn(device)
            print(f"===== {name} done in {time.time()-t0:.0f}s; kernel launches "
                  f"{dict(kv for k in _kernels() for kv in k.LAUNCHES.items())} =====")
        except Exception as e:  # one table must not sink the suite
            print(f"===== {name} FAILED after {time.time()-t0:.0f}s: "
                  f"{type(e).__name__}: {e} =====")


if __name__ == "__main__":
    main()
