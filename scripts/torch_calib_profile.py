#!/usr/bin/env python3
"""Where the time of the port's BRECQ calibration goes, on one GPU.

Calibrates brecq-lm-100m at full width (d_model 768, 12 heads, d_ff 2048,
vocab 8192), depth cut to ``--layers``, random weights from seed 0, W2,
32 calibration sequences of 128 tokens, through
``repro_torch.core.quantize`` (block units, streamed Fisher, bf16
streams), once to warm up, once timed alone and once under
``torch.profiler``. Prints both walls, the device time (the sum of every
kernel's time: one stream, so kernels do not overlap), the device's busy
share of each wall (the profiler slows the host, not the kernels, so the
share of the plain wall is the one that holds without it),
the optimization rate and the operators whose kernels take the most
device time, with the card's name and power limit.

    PYTHONPATH=src python3 scripts/torch_calib_profile.py [--layers 2] [--iters 50]

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_calib_profile: no CUDA device")
    from repro_torch.core import ReconConfig, quantize
    from repro_torch.data import Corpus, CorpusConfig, make_batches
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config("brecq_lm_100m"), n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    calib = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 4, 8, 128, seed=1)
    rc = ReconConfig(w_bits=2, iters=args.iters, calib_bs=8)
    quantize(model, params, calib, dataclasses.replace(rc, iters=5))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize(model, params, calib, rc)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    fq_kernel.reset_launches()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        res = quantize(model, params, calib, rc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev(e) -> float:  # microseconds
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # kernel events carry the device time; an operator's self device time
    # is its kernels' again, so only the kernels are summed
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in rows if e.device_type == cuda]
    ops = [e for e in rows if e.device_type != cuda]
    device_s = sum(dev(e) for e in kernels) / 1e6
    st = res.stats
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"brecq-lm-100m full width, {args.layers} layers, W2, iters {args.iters}: "
          f"wall {plain_wall:.3f} s alone, {wall:.3f} s under the profiler; device "
          f"{device_s:.3f} s; busy share {device_s / plain_wall:.3f} of the wall "
          f"alone ({device_s / wall:.3f} under the profiler); calib_iters_per_s "
          f"{st['calib_iters_per_s']:.1f}, fisher_wall_s {st['fisher_wall_s']:.3f}, "
          f"fakequant launches {fq_kernel.LAUNCHES['fakequant']}")
    print(f"device time per optimization iteration ~ "
          f"{device_s / (args.layers * args.iters) * 1e3:.3f} ms (Fisher, probes and "
          f"hard forwards included)")
    top = sorted((e for e in ops if dev(e) > 0), key=dev, reverse=True)[:args.top]
    print(f"operators by their kernels' device time ({len(kernels)} kernel names):")
    for e in top:
        print(f"  {dev(e) / 1e3:9.3f} ms  {e.count:7d} calls  {e.key[:90]}")


if __name__ == "__main__":
    main()
