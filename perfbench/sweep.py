"""Find the highest rate a serving cell sustains: one set-up, then one window
at each offered rate, the engine emptied between them.

    python perfbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --rates <r> [<r> ...] [--out <file.jsonl>]

For each rate it prints one JSON line: the offered rate, the requests that
arrived and finished, the tokens a second completed, the time to first
token (median and 95th percentile) and the requests still waiting at the
close. Below the knee the finished requests follow the arrivals and the
waiting queue stays short; above it the queue grows through the window.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    cell = harness.cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"], ROOT)
    mix = harness.load_mix(cell["traffic"])
    drv = harness.load_driver(mix["driver"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    engine, _steps = drv.build(config, mix, args.seed, device)
    sink = open(args.out, "a") if args.out else None
    for rate in args.rates:
        t0 = time.perf_counter()
        e2e, facts, states, _tw = drv.window(engine, config, mix, args.seed, args.seconds,
                                             False, rate=rate, backlog=0)
        for uid, s in states.items():
            if s in ("waiting", "prefill", "decode"):
                engine.cancel(uid)
        line = json.dumps(dict(
            workload=args.workload, rate=rate, arrived=facts["requests"],
            finished=facts["finished"], waiting_at_close=facts["waiting_at_close"],
            serve_tok_s=e2e["serve_tok_s"], ttft_p50_ms=facts["ttft_p50_ms"],
            ttft_p95_ms=e2e["ttft_p95_ms"], itl_p95_ms=e2e["itl_p95_ms"],
            wall_s=time.perf_counter() - t0))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
