"""The int8 data-parallel step's loss curve beside the uncompressed one, over seeds.

For each seed, two spawned gloo ranks (on the one GPU, or on the CPU) run
``repro_torch.dist.checks.dp_int8``: brecq-lm-100m at full width and depth
(``--reduced`` for the small config), ``--steps`` steps of
``make_dp_train_step`` on one global batch of ``--batch`` x ``--seq``
tokens drawn from the seed, once with the int8 error-feedback all-reduce
and once with the f32 mean (``grad_compress.mean_psum``), both from the
seed's initial weights. Prints, per seed, both curves, the largest gap
between them and where it falls, the last step's signed gap (int8 - f32),
how many steps the int8 curve runs ahead of or behind the f32 one, and
the f32 curve's mean drop a step; a JSON summary is the last line (also
written to ``--out`` when given). ``chip_smoke.py``'s ``DIST_LOSS_ABOVE``
and ``DIST_LOSS_BELOW`` are set from these readings.

    PYTHONPATH=src python scripts/dp_int8_gap.py [--seeds 0 1 2 3 4] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def steps_off(a: list, b: list):
    """The fewest steps k such that each a[t] lies within the range of b
    over steps t - k .. t + k: how far, in steps, one curve runs ahead of
    or behind the other. None where some a[t] lies outside all of b."""
    worst = 0
    for t, x in enumerate(a):
        for k in range(len(b)):
            w = b[max(0, t - k):t + k + 1]
            if min(w) <= x <= max(w):
                worst = max(worst, k)
                break
        else:
            return None
    return worst


def summary(seed: int, r: dict) -> dict:
    a, b = r["int8_losses"], r["f32_losses"]
    gaps = [x - y for x, y in zip(a, b)]
    worst = max(range(len(gaps)), key=lambda i: abs(gaps[i]))
    return {"seed": seed, "int8_losses": a, "f32_losses": b,
            "max_abs_gap": abs(gaps[worst]), "max_gap_step": worst,
            "last_gap": gaps[-1], "steps_off": steps_off(a, b),
            "f32_drop": b[0] - b[-1],
            "f32_drop_per_step": (b[0] - b[-1]) / (len(b) - 1),
            "unequal": r["unequal"], "err_abs_sum": r["err_abs_sum"],
            "int8_s_per_step": r["int8_s_per_step"], "f32_s_per_step": r["f32_s_per_step"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.dist import checks, spawn

    calls = [("dp_int8", ("brecq_lm_100m", args.reduced, args.device, args.batch,
                          args.seq, args.steps, s)) for s in args.seeds]
    res = spawn.run_ranks(checks.several, 2, calls, timeout=3000)[0]
    rows = [summary(s, r) for s, r in zip(args.seeds, res)]
    for r in rows:
        print(f"seed {r['seed']}: int8 {[round(x, 4) for x in r['int8_losses']]}")
        print(f"        f32  {[round(x, 4) for x in r['f32_losses']]}")
        print(f"        max |gap| {r['max_abs_gap']:.4f} at step {r['max_gap_step']}, last "
              f"gap {r['last_gap']:+.4f}, int8 within {r['steps_off']} steps of f32, "
              f"f32 drop {r['f32_drop']:.4f} ({r['f32_drop_per_step']:.4f} a step); int8 "
              f"{r['int8_s_per_step'] * 1e3:.0f} ms/step, f32 "
              f"{r['f32_s_per_step'] * 1e3:.0f}")
    out = {"device": args.device, "reduced": args.reduced, "steps": args.steps,
           "batch": [args.batch, args.seq], "seeds": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"max_abs_gap": [r["max_abs_gap"] for r in rows],
                      "last_gap": [r["last_gap"] for r in rows],
                      "steps_off": [r["steps_off"] for r in rows]}))


if __name__ == "__main__":
    main()
