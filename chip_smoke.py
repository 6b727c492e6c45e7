#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Drives the port (``src/repro_torch``) only, never the JAX package:

  1. build   compile the qmatmul CUDA library from the checkout's sources
  2. parity  hold the ``qgemv`` and ``qmatmul`` kernels against their plain
             PyTorch versions on the card over the serving shapes of
             brecq-lm-100m (plus ragged M and N), for 2/4/8-bit codes,
             per-channel and group-128 scales; time kernel, plain version,
             library yardstick (torch.matmul on the pre-dequantized
             weight) and the bound at the slice shapes
  3. serve   run ``repro_torch.launch.serve.main`` at full width (batch 8,
             prompt 64, gen 32) for --quant 4 and --quant 2, save the
             artifact, serve it again through --artifact; check that both
             kernels were launched, then replay the generated tokens through
             the plain PyTorch path and compare the logits
  4. report  one JSON line of kernels, the card's name and power limit, and
             the final ``{"ok": true, "device": ...}`` line

Exits non-zero on any failure, and when no CUDA device is available.

    python3 chip_smoke.py [--json PATH]
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# outside the tensor cores (the kernels do f32 FMA on CUDA cores).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# (K, N) of one brecq-lm-100m layer's packed matmuls, with how many of the
# layer's 7 matmuls have that shape: wq/wk/wv/wo, w_gate/w_up, w_down.
SLICE_SHAPES = {(768, 768): 4, (768, 2048): 2, (2048, 768): 1}
RAGGED_N = 200
L2_FLUSH_BYTES = 100e6  # weight copies per timing: twice the 50 MB L2
DECODE_M = (1, 8)
PREFILL_M = (512, 520)  # 520: ragged M


def tolerance(ref) -> float:
    """Kernel vs plain version: f32 sums in another order."""
    return 1e-4 * float(ref.abs().max()) + 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(m: int, k: int, n: int, bits: int, g: int) -> tuple[float, str]:
    """Least time (ms) for x (m,k) f32 @ packed (k*bits/8, n) + scales (g,n)
    -> (m,n) f32: each input read once, the output written once, against
    2mkn f32 operations."""
    nbytes = m * k * 4 + k * n * bits // 8 + g * n * 4 + m * n * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 2 * m * k * n / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_time_ms(torch, fn, arg_sets, replays: int = 3) -> float:
    """Device time per call: one call per entry of ``arg_sets`` (whose
    weights together exceed the 50 MB L2, so every call reads its weight
    from device memory, as the serving path does with 84 distinct
    weights per step) captured in one CUDA graph and replayed ``replays``
    times between CUDA events. The graph takes the host's launch overhead
    out of the measurement."""
    reps = max(len(arg_sets), 32)
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del g
    return ms


def phase_build(kernel) -> dict:
    t0 = time.perf_counter()
    kernel.load_library()
    info = dict(kernel.BUILD_INFO)
    print(f"[build] {'compiled' if info['built'] else 'loaded'} "
          f"{info['path']} in {time.perf_counter() - t0:.2f}s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    return info


def phase_parity(torch, kernel, ref, pack) -> tuple[dict, list]:
    """Kernel vs plain version on the card; timings at the slice shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"qgemv": 0.0, "qmatmul": 0.0}
    rows = []
    shapes = list(SLICE_SHAPES) + [(768, RAGGED_N)]
    cases = 0
    for bits in (4, 2, 8):
        for group in (None, 128):
            for (k, n) in shapes:
                w = torch.randn((k, n), generator=gen, device=dev) * 0.02
                wp, s = pack.rtn_pack_leaf(w, bits, group)
                for name, fn, plain, ms in (
                        ("qgemv", kernel.qgemv, ref.qgemv_ref, DECODE_M),
                        ("qmatmul", kernel.qmatmul, ref.qmatmul_ref, PREFILL_M)):
                    for m in ms:
                        x = torch.randn((m, k), generator=gen, device=dev)
                        out = fn(x, wp, s, bits=bits)
                        want = plain(x, wp, s, bits)
                        torch.cuda.synchronize()
                        err = float((out - want).abs().max())
                        tol = tolerance(want)
                        rel = err / max(float(want.abs().max()), 1e-30)
                        cases += 1
                        errs[name] = max(errs[name], err)
                        if not math.isfinite(err) or err > tol:
                            fail(f"{name} W{bits} group={group} M={m} K={k} "
                                 f"N={n}: max abs err {err:.3e} > tol {tol:.3e}")
                        if (k, n) in SLICE_SHAPES and bits in (4, 2) and m in (8, 512):
                            rows.append(_time_case(torch, name, fn, plain, ref,
                                                   x, wp, s, bits, group, m, k, n,
                                                   err, rel))
    print(f"[parity] {cases} kernel-vs-plain cases within "
          f"1e-4*max|ref|+1e-5; max abs err qgemv {errs['qgemv']:.3e}, "
          f"qmatmul {errs['qmatmul']:.3e}")
    return errs, rows


def _time_case(torch, name, fn, plain, ref, x, wp, s, bits, group, m, k, n,
               err, rel) -> dict:
    copies = max(2, math.ceil(L2_FLUSH_BYTES / (wp.numel() + s.numel() * 4)))
    arg_sets = [(x, wp.clone(), s.clone()) for _ in range(copies)]
    t_kernel = graph_time_ms(torch, lambda a, b, c: fn(a, b, c, bits=bits), arg_sets)
    t_plain = graph_time_ms(torch, lambda a, b, c: plain(a, b, c, bits), arg_sets)
    w_deq = ref.dequant(wp, s, bits, k)
    lib_copies = max(2, math.ceil(L2_FLUSH_BYTES / (w_deq.numel() * 4)))
    lib_sets = [(x, w_deq.clone()) for _ in range(lib_copies)]
    t_lib = graph_time_ms(torch, torch.matmul, lib_sets)
    del arg_sets, lib_sets
    b_ms, b_by = bound(m, k, n, bits, s.shape[0])
    row = {"kernel": name, "bits": bits, "group": group, "M": m, "K": k, "N": n,
           "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "max_rel_err": rel}
    print(f"[time] {name:7s} W{bits} g={str(group):4s} M={m:3d} K={k:4d} N={n:4d}: "
          f"kernel {t_kernel*1e3:9.2f} us  plain {t_plain*1e3:9.2f} us  "
          f"library {t_lib*1e3:9.2f} us  bound {b_ms*1e3:7.2f} us ({b_by})  "
          f"err {err:.2e} (rel {rel:.2e})")
    return row


def phase_host(torch, ops, pack) -> dict:
    """Host time per eager call at the decode shape (W4 768x768, M=8): the
    wall time of back-to-back calls, which the host bounds when it is
    slower than the device. ``matmul`` is an FP ``x @ w`` for reference."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn((768, 768), generator=gen, device=dev) * 0.02
    wp, s = pack.rtn_pack_leaf(w, 4, None)
    qw = ops.QuantizedLinear(wp, s, 4, 768)
    x = torch.randn((8, 768), generator=gen, device=dev)

    def per_call_us(fn, n=500):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    host = {"qmm_us": per_call_us(lambda: ops.qmm(x, qw)),
            "matmul_us": per_call_us(lambda: x @ w)}
    print(f"[host] eager call at M=8, 768x768: qmm {host['qmm_us']:.2f} us, "
          f"FP matmul {host['matmul_us']:.2f} us")
    return host


def phase_serve(torch, kernel, ops, serve, workdir: Path) -> tuple[dict, list]:
    """The main path at full width, W4 and W2; kernel launches counted."""
    from repro_torch.data import Corpus, CorpusConfig
    from repro_torch.deploy import QuantizedArtifact
    from repro_torch.models import get_model
    from repro_torch.models.common import NO_QUANT

    launches = {"qgemv": 0, "qmatmul": 0}
    results = []
    common = ["--arch", "brecq_lm_100m", "--batch", "8", "--prompt-len", "64",
              "--gen-len", "32", "--seed", "0"]
    for bits in (4, 2):
        art_dir = workdir / f"w{bits}"
        kernel.reset_launches()
        ops.reset_tier_counts()
        first = serve.main([*common, "--quant", str(bits),
                            "--save-artifact", str(art_dir)])
        again = serve.main([*common, "--artifact", str(art_dir),
                            "--no-compare-fp"])
        run = dict(kernel.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        tiers = first["stats"]["qmm_tiers"]
        print(f"[serve W{bits}] kernel launches {run}; qmm tiers {tiers}")
        if run["qgemv"] == 0 or run["qmatmul"] == 0:
            fail(f"W{bits} serve did not launch both kernels: {run}")
        if tiers["decode"] == 0 or tiers["prefill"] == 0:
            fail(f"W{bits} serve did not dispatch both tiers: {tiers}")
        if not torch.equal(first["tokens"], again["tokens"]):
            fail(f"W{bits}: serving the reloaded artifact gave other tokens")

        # replay the kernel path's tokens through the plain version
        cfg, model = get_model("brecq_lm_100m")
        art = QuantizedArtifact.load(str(art_dir)).to("cuda")
        prompts = Corpus(CorpusConfig(vocab=cfg.vocab)).sample(8, 64, seed=7)
        batch = {"tokens": torch.from_numpy(prompts).cuda()}
        gen = first["tokens"]
        logits = {}
        with torch.inference_mode():
            for backend in ("cuda", "torch"):
                hook = copy.copy(NO_QUANT)
                hook.packed_backend = backend
                cache = model.init_cache(8, 96, torch.float32, "cuda")
                step, cache = model.prefill(art.params, batch, cache, hook)
                steps = [step]
                for i in range(gen.shape[1] - 1):
                    pos = torch.full((8,), 64 + i, dtype=torch.int32, device="cuda")
                    step, cache = model.decode_step(art.params, gen[:, i:i + 1],
                                                    cache, pos, hook)
                    steps.append(step)
                logits[backend] = torch.stack(steps, 1)  # (B, gen, V)
        got, want = logits["cuda"], logits["torch"]
        err = float((got - want).abs().max())
        # 12 layers x 7 packed matmuls compound the per-matmul f32 order error
        tol = 1e-3 * float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if not bool(torch.isfinite(got).all()) or err > tol:
            fail(f"W{bits}: kernel-path logits differ from the plain path by "
                 f"{err:.3e} > {tol:.3e}")
        if not torch.equal(got.argmax(-1), gen.long()):
            fail(f"W{bits}: replayed kernel-path logits do not reproduce the "
                 f"served tokens")
        st = first["stats"]
        print(f"[serve W{bits}] logits kernel vs plain: max abs err {err:.3e} "
              f"(tol {tol:.3e}); greedy token agreement {agree:.4f}; artifact "
              f"{first['artifact_bytes']} B vs fp {first['fp_bytes']} B; "
              f"prefill {st['prefill_tok_s']:.1f} tok/s, decode "
              f"{st['tok_s']:.1f} tok/s (fp: prefill "
              f"{first['fp_stats']['prefill_tok_s']:.1f}, decode "
              f"{first['fp_stats']['tok_s']:.1f})")
        results.append({"bits": bits, "launches": run, "qmm_tiers": tiers,
                        "logits_max_abs_err": err, "token_agreement": agree,
                        "artifact_bytes": first["artifact_bytes"],
                        "fp_bytes": first["fp_bytes"], "stats": st,
                        "fp_stats": first["fp_stats"]})
    return launches, results


def kernel_line(errs, rows, launches) -> dict:
    """One entry per kernel: one layer's 7 matmuls at the main path's
    W4 per-channel setting (decode M=8 for qgemv, prefill M=512 for
    qmatmul), summed over the layer's shapes."""
    meta = {"qgemv": ("src/repro/kernels/qmatmul/kernel.py:140", 8),
            "qmatmul": ("src/repro/kernels/qmatmul/kernel.py:83", 512)}
    out = []
    for name, (replaces, m) in meta.items():
        sel = [r for r in rows if r["kernel"] == name and r["bits"] == 4
               and r["group"] is None and r["M"] == m]
        tot = {key: sum(SLICE_SHAPES[(r["K"], r["N"])] * r[key] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by = {r["bound_by"] for r in sel}
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": by.pop() if len(by) == 1 else "bytes",
            "library_ms": tot["library_ms"],
            "shapes": f"one layer: 4x768x768, 2x768x2048, 1x2048x768; W4 "
                      f"per-channel; M={m}"})
    return {"kernels": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's package is missing: {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.deploy import pack
    from repro_torch.kernels.qmatmul import kernel, ops, ref
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    build = phase_build(kernel)
    errs, rows = phase_parity(torch, kernel, ref, pack)
    host = phase_host(torch, ops, pack)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, served = phase_serve(torch, kernel, ops, serve, Path(tmp))

    line = kernel_line(errs, rows, launches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": device, "nvidia_smi": smi, "build": build,
             "timings": rows, "host": host, "serve": served, "kernels": line["kernels"],
             "wall_s": time.perf_counter() - t_start}, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
