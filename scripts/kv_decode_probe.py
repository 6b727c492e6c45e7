#!/usr/bin/env python3
"""Time ``kv_decode`` (K4) per launch plan on one GPU: the source of
``spec.plan_kv_decode``'s choice.

The dense entry at the engine's decode shape (B 8, H = K 12, hd 64, S 96),
at S 1024, 2048 and 4096, and at h2o-danube3-4b's heads (H 32 over K 8, hd
120, S 96), with warps and split forced to each legal plan (4 and 8 warps,
splits 1..8, no empty share), timed as ``chip_smoke.py`` times kernels (a
CUDA graph over copies of the inputs that exceed the L2 cache), beside the
bound ``chip_smoke.kv_bound`` gives; the plan's own choice is marked. With
``--baseline SRC``, the same shapes through an earlier revision's
``kvattn.cu`` (its dense C entry taking B, H, K, S, hd, window and the load
unit), built beside the current one and timed in the same call. Parity of
every plan is held by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Prints the card's name and power limit first.

    PYTHONPATH=src python3 scripts/kv_decode_probe.py [--baseline SRC] [--json PATH]

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TIMED = {"engine": (8, 12, 12, 64, 96), "s1024": (8, 12, 12, 64, 1024),
         "s2048": (8, 12, 12, 64, 2048), "s4096": (8, 12, 12, 64, 4096),
         "hd120": (8, 32, 8, 120, 96)}


def plans(spec, S, hd, G=1):
    """Legal plans of the shape: 4 and 8 warps, splits 1..8 (no empty
    share)."""
    return [spec.kv_plan(hd, G, warps, split) for warps in spec.KV_WARPS
            for split in spec.KV_SPLITS if split <= -(-S // spec.KV_TILE)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="another revision's kvattn.cu to time beside this one")
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, spec
    from repro_torch.kernels.kvattn import kernel
    from repro_torch.kernels.kvattn.ref import kv_decode_ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    kernel.load_library()
    for line in kernel.BUILD_INFO["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")
    base = None
    if args.baseline:
        base, info = build.build_library("kvattn_base", (Path(args.baseline),))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        base.kv_decode_launch.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        base.kv_decode_launch.restype = i32

    rows = []
    for label, (B, H, K, hd, S) in TIMED.items():
        a = cs.kv_inputs(torch, B, H, K, hd, S, seed=1)
        per_set = sum(t.numel() * t.element_size() for t in a)
        sets = [tuple(t.clone() for t in a) for _ in range(max(2, math.ceil(
            cs.L2_FLUSH_BYTES / per_set)))]
        b_ms, b_by = cs.kv_bound(a[0], a[5], a[6], K)
        chosen = spec.plan_kv_decode(B, K, S, hd, H // K)
        if base is not None:
            vb = spec.KV_BODIES[spec.kv_decode_body(hd)]

            def old(q, k8, v8, ks, vs, kpos, cur):
                out = torch.empty_like(q)
                base.kv_decode_launch(q.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                                      ks.data_ptr(), vs.data_ptr(), kpos.data_ptr(),
                                      cur.data_ptr(), out.data_ptr(), B, H, K, S, hd, -1,
                                      vb, torch.cuda.current_stream().cuda_stream)
                return out

            want = kv_decode_ref(*a)
            err = float((old(*a) - want).abs().max())
            ms = cs.graph_time_ms(torch, old, sets)
            rows.append({"label": label, "plan": "baseline", "ms": ms, "bound_ms": b_ms,
                         "max_abs_err": err})
            print(f"[time] {label:6s} baseline: {ms * 1e3:8.2f} us (bound {b_ms * 1e3:.2f} "
                  f"us, {b_by}; err {err:.1e})", flush=True)
        for plan in plans(spec, S, hd, H // K):
            ms = cs.graph_time_ms(
                torch, lambda *t, p=plan: kernel.kv_decode(*t, plan=p), sets)
            mark = " <- plan" if plan[:-1] == chosen[:-1] else ""
            rows.append({"label": label, "plan": plan._asdict(), "ms": ms,
                         "bound_ms": b_ms, "chosen": bool(mark)})
            print(f"[time] {label:6s} warps {plan.warps} split {plan.split}: "
                  f"{ms * 1e3:8.2f} us (bound {b_ms * 1e3:.2f}){mark}",
                  flush=True)
        del sets
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
