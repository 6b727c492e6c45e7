"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, the program's kernels built or loaded from
``build/kernels/``, every shape of the cell warmed) runs first and counts
as ``setup_s``, from the start of this script to the window's start. The
window then measures for ``--seconds``; the program's state is freed and
the plain reference judges what the window produced. The last line of
standard output is one JSON object; the numbers compared for ``correct``
are printed beside their limits as the last lines of standard error and
under the line's last key, ``checks``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Every cache the program or its libraries write stays at a fixed path
    inside the checkout (the kernels' own in ``build/kernels/``); nothing
    loads JAX through transformers; the port and the harness import from
    the checkout."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from perfbench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"], ROOT)
    mix = harness.load_mix(cell["traffic"])
    driver = harness.load_driver(mix["driver"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = driver.run(config=config, mix=mix, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=T_START)

    bad = harness.forbidden_loaded(sys.modules)
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": int(run.memory_peak_bytes)}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    line = harness.result_line(spec, args.workload, run, bool(args.trace), dev)
    small = {k: v for k, v in run.facts.items() if isinstance(v, (int, float, bool))}
    if run.trace is not None:
        small.update(trace_offset_ns=run.trace.offset_ns, trace_samples=len(run.trace.samples),
                     trace_device_events=len(run.trace.device_events))
    print(f"perfbench: {json.dumps(small)}", file=sys.stderr)
    for name, v, lim in run.checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
