#!/usr/bin/env python3
"""Probe of the packed matmuls' tensor-core body on one GPU.

1. rates: the card's rate for the tensor-core instructions a
   packed-matmul mainloop can be built from, each issued back to back by
   every warp on its own registers (no loads): mma.sync m16n8k8 TF32 and
   m16n8k16 bf16 at 4, 8 and 16 warps an SM, and wgmma m64n128k8 TF32 and
   m64n128k16 bf16 (A from registers, B from shared memory) at 1 and 2
   warpgroups an SM. A small CUDA program, compiled with nvcc into
   build/tc_rates/.
2. splits: ``kernels.qmatmul.kernel.qmatmul`` (and ``qmatmul_grouped``)
   at the main path's shapes (brecq-lm-100m's three linear shapes at M 32
   and 512, deepseek-moe-16b's routed experts at M 64, E 64; W4
   per-channel) with the plan's split of K forced to each of 1, 2, 4 and 8,
   timed as ``chip_smoke.py`` times them (weights cold in L2, CUDA graph).

Prints the card's name and power limit first.

    PYTHONPATH=src python3 scripts/qmm_tc_probe.py [--skip-rates] [--skip-splits]

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

RATES_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__global__ void k_tf32(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0;
  for (int j = 0; j < 8; ++j) for (int c = 0; c < 4; ++c) s += acc[j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_bf16(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0;
  for (int j = 0; j < 8; ++j) for (int c = 0; c < 4; ++c) s += acc[j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_wgmma(float* out, int iters) {
  __shared__ __align__(128) float bs[128 * 8];
  for (int i = threadIdx.x; i < 128 * 8; i += blockDim.x) bs[i] = 1.0f;
  __syncthreads();
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(bs));
  uint64_t desc = ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
                   " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {DLIST}, "
                   "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                   : OUTS
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_wgmma_bf16(float* out, int iters) {
  __shared__ __align__(128) float bs[128 * 8];
  for (int i = threadIdx.x; i < 128 * 8; i += blockDim.x) bs[i] = 1.0f;
  __syncthreads();
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(bs));
  uint64_t desc = ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
                   " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {DLIST}, "
                   "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                   : OUTS
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, size_t(sms) * 16 * 1024 * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  float ms;
  k_tf32<<<sms, 32>>>(out, 16);  // warm-up
  cudaDeviceSynchronize();
  for (int warps : {4, 8, 16}) {
    const int blocks = sms * 4, threads = 32 * warps / 4;
    const double mmas = double(blocks) * (warps / 4) * iters * 8;
    cudaEventRecord(e0);
    k_tf32<<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("[rates] mma.sync m16n8k8 tf32, %2d warps an SM: %.1f TFLOP/s\n", warps,
           mmas * 2 * 16 * 8 * 8 / ms / 1e9);
    cudaEventRecord(e0);
    k_bf16<<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("[rates] mma.sync m16n8k16 bf16, %2d warps an SM: %.1f TFLOP/s\n", warps,
           mmas * 2 * 16 * 8 * 16 / ms / 1e9);
  }
  for (int wg : {1, 2}) {
    const int blocks = sms * wg;
    cudaEventRecord(e0);
    k_wgmma<<<blocks, 128>>>(out, iters / 4);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("[rates] wgmma m64n128k8 tf32, %d warpgroup(s) an SM: %.1f TFLOP/s (%s)\n", wg,
           double(blocks) * (iters / 4) * 8 * 2.0 * 64 * 128 * 8 / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
    cudaEventRecord(e0);
    k_wgmma_bf16<<<blocks, 128>>>(out, iters / 4);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("[rates] wgmma m64n128k16 bf16, %d warpgroup(s) an SM: %.1f TFLOP/s (%s)\n", wg,
           double(blocks) * (iters / 4) * 8 * 2.0 * 64 * 128 * 16 / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""


def rates() -> None:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    dl = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    out = ROOT / "build" / "tc_rates"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rates.cu").write_text(RATES_CU.replace("DLIST", dl).replace("OUTS", outs))
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_nvcc(), *flags, "-o", str(out / "rates"), str(out / "rates.cu")],
                   check=True, capture_output=True, text=True)
    print(subprocess.run([str(out / "rates")], check=True, capture_output=True,
                         text=True, timeout=300).stdout, end="", flush=True)


def splits(torch) -> None:
    import chip_smoke as cs
    from repro_torch.deploy import pack
    from repro_torch.kernels.qmatmul import kernel

    planned = kernel.plan_qmatmul
    force = {}

    def plan(*a, **kw):
        p = planned(*a, **kw)
        return p._replace(split=force["split"]) if force and p.body == "tc" else p

    kernel.plan_qmatmul = plan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for m in (32, 512):
        for (k, n) in cs.SLICE_SHAPES:
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            wp, s = pack.rtn_pack_leaf(w, 4, None)
            cases.append((kernel.qmatmul, m, 1, k, n,
                          torch.randn((m, k), generator=gen, device=dev), wp, s))
    for (k, n) in cs.MOE_SHAPES:
        w = torch.randn((cs.MOE_E, k, n), generator=gen, device=dev) * 0.02
        wp, s = pack.rtn_pack_leaf(w, 4, None)
        cases.append((kernel.qmatmul_grouped, 64, cs.MOE_E, k, n,
                      torch.randn((cs.MOE_E, 64, k), generator=gen, device=dev), wp, s))
    for fn, m, e, k, n, x, wp, s in cases:
        copies = max(2, math.ceil(cs.L2_FLUSH_BYTES / (wp.numel() + s.numel() * 4)))
        sets = [(x, wp.clone(), s.clone()) for _ in range(copies)]
        want = fn(x, wp, s, bits=4)
        res = []
        for split in (1, 2, 4, 8):
            force["split"] = split
            got = fn(x, wp, s, bits=4)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or err > cs.tolerance(want):
                sys.exit(f"split {split} disagrees at M={m} K={k} N={n}")
            ms = cs.graph_time_ms(torch, lambda a, b, c: fn(a, b, c, bits=4), sets)
            res.append(f"split {split}: {ms * 1e3:7.2f} us")
        force.clear()
        p = planned(m, k, n, 1, 4, e, fn is kernel.qmatmul_grouped)
        print(f"[splits] {fn.__name__} E={e} M={m} K={k} N={n} ({p.tile}, plan split "
              f"{p.split}): " + "  ".join(res), flush=True)
    kernel.plan_qmatmul = planned


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-rates", action="store_true")
    ap.add_argument("--skip-splits", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("qmm_tc_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    if not args.skip_rates:
        rates()
    if not args.skip_splits:
        splits(torch)


if __name__ == "__main__":
    main()
