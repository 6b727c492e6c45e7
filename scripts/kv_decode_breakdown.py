#!/usr/bin/env python3
"""Where ``kv_decode``'s time goes on one GPU: the kernel beside builds of
its source with parts of the body taken out.

Each variant is the checkout's ``csrc/kvattn.cu`` built with one of its
diagnostic cuts (``-DKV_CUT=n``, defined in the source) into its own
library, and timed through the dense C entry under the plan
``spec.plan_kv_decode`` picks, as ``chip_smoke.py`` times kernels (a CUDA
graph over copies of the inputs that exceed the L2 cache), at the engine's
decode shape (B 8, H = K 12, hd 64, S 96), at S 4096 and at hd 120:

  kernel       KV_CUT 0: the source as the port builds it
  loads_only   KV_CUT 1: every tile's copies and waits, no scores, no P @ V
  no_merge     KV_CUT 2: everything up to the warps' own results, no block
               or cluster merge and no output
  prologue     KV_CUT 3: the launch, the first copies and q, the wait for
               them and the merge, no tile
  empty        KV_CUT 4: a kernel that returns at once (the launch)

Outputs other than the kernel's are garbage.

    PYTHONPATH=src python3 scripts/kv_decode_breakdown.py [--json PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/kvattn/csrc/kvattn.cu"
VARIANTS = {"kernel": 0, "loads_only": 1, "no_merge": 2, "prologue": 3, "empty": 4}
SHAPES = {"engine": (8, 12, 12, 64, 96), "s4096": (8, 12, 12, 64, 4096),
          "hd120": (8, 32, 8, 120, 96)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, spec
    from repro_torch.kernels.kvattn.ref import kv_decode_ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    def build_cut(cut):
        lib, _ = build.build_library(f"kvattn_cut{cut}", (SOURCE,),
                                     (*build.NVCC_FLAGS, f"-DKV_CUT={cut}"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kv_decode_launch.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
        lib.kv_decode_launch.restype = i32
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc a variant, together
        libs = dict(zip(VARIANTS, pool.map(build_cut, VARIANTS.values())))

    rows = []
    for label, (B, H, K, hd, S) in SHAPES.items():
        a = cs.kv_inputs(torch, B, H, K, hd, S, seed=1)
        want = kv_decode_ref(*a)
        per_set = sum(t.numel() * t.element_size() for t in a)
        sets = [tuple(t.clone() for t in a)
                for _ in range(max(2, math.ceil(cs.L2_FLUSH_BYTES / per_set)))]
        plan = spec.plan_kv_decode(B, K, S, hd, H // K)
        smem = spec.kv_smem(plan.rows, hd, plan.warps)
        vb = spec.KV_BODIES[plan.body]
        for name, lib in libs.items():
            def fn(q, k8, v8, ks, vs, kpos, cur, lib=lib):
                o = torch.empty_like(q)
                err = lib.kv_decode_launch(
                    q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                    kpos.data_ptr(), cur.data_ptr(), o.data_ptr(), B, H, K, S, hd, -1, vb,
                    plan.warps, plan.split, plan.rows, plan.units, smem,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    cs.fail(f"variant {name} at {label}: launch refused ({err})")
                return o
            err = float((fn(*a) - want).abs().max())
            ms = cs.graph_time_ms(torch, fn, sets)
            rows.append({"shape": label, "variant": name, "ms": ms, "max_abs_err": err,
                         "warps": plan.warps, "split": plan.split})
            print(f"[time] {label:6s} {name:10s}: {ms * 1e3:8.2f} us  ({plan.warps} warps, "
                  f"split {plan.split}{'' if name != 'kernel' else f'; err {err:.1e}'})",
                  flush=True)
        del sets
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
