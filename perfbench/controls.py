"""Readings that set the limits of ``correct``: the program's, the control's
and, for the calibration cell, each planted fault's, at the cell's own size.

    python perfbench/controls.py --workload <name> --seeds <n> [<n> ...] \
        --seconds <s> [--faults] [--out <file.jsonl>]

For every seed it builds the cell as a run does, runs its window, and
reads the compared numbers three ways:

* ``program``: the plain reference in float32 (TF32 off) judging the
  program's output, as a run does;
* ``control``: the reference in bfloat16, the next precision down, put in
  the program's place: for a serving cell, its answer is at each served
  position the token the bfloat16 reference puts first, judged by the
  driver's own ``judge`` and ``checks`` with the mix's limit (``correct``
  has to come out false); for the calibration cell, the bfloat16
  reference's losses and stream read against the float32 reference's
  (``reference/calib.py``);
* with ``--faults`` (calibration): the window run again with a fault
  planted in the program, judged by the float32 reference: ``unchanged``
  (Adam returns the rounding logits as they were), ``half`` (each
  minibatch keeps half its rows, the loss their mean), ``altered`` (every
  hardened weight has its first output column moved by one step).

The benchmark's own runs never run this. One JSON line per seed and
reading goes to ``--out`` and to standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(config, mix, seed, seconds, device):
    import numpy as np
    import torch

    from perfbench import harness
    from perfbench.reference.model import control_tokens

    drv = harness.load_driver("serve")
    engine, _steps = drv.build(config, mix, seed, device)
    _e2e, facts, states, _tw = drv.window(engine, config, mix, seed, seconds, False)
    picked = drv.served(engine, drv.sample(engine, states, mix, seed))
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference(config, mix, seed, device)
    low = drv.reference(config, mix, seed, device, torch.bfloat16)
    ctrl = []
    for prompt, gen, _answer in picked:
        toks = torch.as_tensor(np.concatenate([prompt, np.asarray(gen[:-1], np.int32)]),
                               device=device)
        ctrl.append((prompt, gen, control_tokens(low, toks, len(prompt), len(gen)).tolist()))
    del low
    rows = []
    for reading, answers in (("program", picked), ("control", ctrl)):
        gap, n = drv.judge(ref, answers, device)
        run = harness.Run(end_to_end={}, attempted=len(states), failed=0,
                          checks=drv.checks(gap, mix), memory_peak_bytes=0)
        rows.append({"reading": reading, "served_logit_gap": gap, "correct": run.correct,
                     "limit": mix["check"]["limit"], "tokens": n, "requests": len(picked),
                     "finished": facts["finished"]})
    return rows


class _Faults:
    """Plants one fault in the program and takes it out again."""

    def __init__(self, name):
        self.name, self.undo = name, []

    def __enter__(self):
        import repro_torch.core.adaround as ar
        import repro_torch.core.calib_loop as cl
        import repro_torch.optim.adam as adam

        def patch(mod, attr, new):
            self.undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, new)

        if self.name == "unchanged":
            patch(adam, "update", lambda cfg, grads, state, params, lr_tree=None: (params, state))
        elif self.name == "half":
            orig = cl.get_unit_programs
            patch(cl, "get_unit_programs",
                  lambda model, walker, sd, dec, cfgs, rc, bs, n, *a:
                  orig(model, walker, sd, dec, cfgs, rc, max(1, bs // 2), n, *a))
        elif self.name == "altered":
            orig_h = ar.hard_quant

            def hard(w, v, st, cfg):
                out = orig_h(w, v, st, cfg).clone()
                out[..., 0] += st.scale.reshape(-1)[0]
                return out

            patch(ar, "hard_quant", hard)
        return self

    def __exit__(self, *exc):
        for mod, attr, old in reversed(self.undo):
            setattr(mod, attr, old)


def calib_readings(config, mix, seed, seconds, device, faults: bool):
    import torch

    from perfbench import harness
    from perfbench.reference.calib import CalibRef, judge
    from perfbench.reference.model import no_tf32

    drv = harness.load_driver("calib")
    model, params, tokens, _steps = drv.build(config, mix, seed, device)
    steps = mix["check"]["steps"]
    out = []

    def judged(journal, dtype=torch.float32):
        no_tf32()
        ref = CalibRef(params, config, mix, tokens, dtype=dtype)
        got = judge(ref, {"units": journal["units"],
                          "v": {k: t.to(device) for k, t in journal["v"].items()},
                          "x_q": journal["x_q"].to(device)}, seed, steps)
        run = harness.Run(end_to_end={}, attempted=len(journal["units"]), failed=0,
                          checks=drv.checks(got, mix), memory_peak_bytes=0)
        return dict(got, correct=run.correct)

    wall, journal, _i, _r, _t = drv.window(model, params, tokens, config, mix, seed,
                                           seconds, False, device)
    out.append(dict(reading="program", units=len(journal["units"]), wall_s=wall,
                    **judged(journal)))
    out.append(dict(reading="control", **judged(journal, torch.bfloat16)))
    if faults:
        for name in ("unchanged", "half", "altered"):
            with _Faults(name):
                _w, jf, _i, _r, _t = drv.window(model, params, tokens, config, mix, seed,
                                                seconds, False, device)
            out.append(dict(reading=name, units=len(jf["units"]), **judged(jf)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    cell = harness.cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"], ROOT)
    mix = harness.load_mix(cell["traffic"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        if mix["driver"] == "serve":
            rows = serve_readings(config, mix, seed, args.seconds, device)
        else:
            rows = calib_readings(config, mix, seed, args.seconds, device, args.faults)
        for r in rows:
            line = json.dumps(dict(workload=args.workload, seed=seed,
                                   seconds=time.perf_counter() - t0, **r))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
