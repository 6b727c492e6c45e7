"""CUDA packed dequant-matmul kernels for Hopper: build, binding, launch.

Three hand-written kernels in ``csrc/qmatmul.cu`` replace the JAX
package's Pallas TPU kernels (``src/repro/kernels/qmatmul/kernel.py``):

  qgemv    replaces ``kernel.py::qgemv`` (decode, M <= 8 rows). The
           tensor-core decode body: mma.sync.m16n8k16 bf16 with the
           operands swapped (out^T = W^T x^T: 16 weight columns of codes,
           exact in bf16, against x^T with the batch rows as the MMA's 8
           columns, x in three bf16 passes, < 2^-21 relative a product),
           each group's scale applied to its partial sum. Under 1 MB of
           packed weight per call, so latency is its limit: a block per 16
           columns over all of K, its 16 warps each streaming their 16-k
           units through their own cp.async ring (all issued before the
           first MMA), meeting once in shared memory in warp order. Scale
           groups that are not a whole number of 16 k take the CUDA-core
           decode body (a block per 64 columns over all of K, each code
           scaled as it is decoded). qgemv launches as qmatmul_grouped
           with one expert.
  qmatmul  replaces ``kernel.py::qmatmul`` (prefill GEMM, any M). The
           tensor-core body: MMAs on exact integer codes with x split so
           that its parts carry it to < 2^-21 relative (well inside the
           1e-4 kernel-vs-plain limit), each group's scale applied to its
           partial sum. Up to 32 rows a 32 x 32 mma.sync TF32 tile (x =
           hi + lo, two passes) unpacks packed bytes straight into B
           fragments under a k-permutation that puts both k of a thread's
           fragment in one byte; above, one warpgroup's wgmma.m64n128k16
           bf16 (x = h1 + h2 + h3, three passes: cheaper than two TF32
           passes) reads B tiles unpacked once per block into shared
           memory. x and code tiles stream through a cp.async ring; K
           splits over a cluster of up to 8 blocks (summed in rank order
           through distributed shared memory) until the grid fills the
           card. Bound by the passes' operations at M 512; at the engine's
           32-row chunk by latency. Scale groups that are not a whole
           number of k-units (8 k, 16 for W2) take the CUDA-core body (64 x
           64 f32 FMA tile).
  qmatmul_grouped  replaces ``kernel.py::qmatmul_grouped`` (stacked MoE
           experts, x (E, M, K) @ (E, K*bits/8, N) codes). M <= 8 runs
           qgemv's decode body with the expert on the grid, a block per
           128 columns streaming the 92 MB of W4 codes a call (bound by
           bytes); more rows take qmatmul's tensor-core body with the
           expert on the grid. Short scale groups keep CUDA-core bodies.
           Operands are found by offsets into the stacked codes, so no (E,
           K, N) dequantized copy exists.

The body, tile and split of a call come from ``spec.plan_qmatmul`` /
``spec.plan_qgemv`` (the shape alone) and are passed to the launcher; :data:`BODY_LAUNCHES` counts
launches per body. All mask ragged M, N and K, so the TPU-only padding of
``ops._qmm_2d`` does not exist here, and all are deterministic (fixed
summation orders, no atomics). The library is compiled with ``nvcc`` for
``sm_90a`` at first use, from the sources beside this file, through
``kernels/build.py`` (``build/kernels/`` at the repository root, keyed by a
hash of the sources and flags), and bound through ``ctypes``. Nothing is
built when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output, launches on the current stream, raises if the launch was refused
and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_dir, build_library, on_device  # noqa: F401 (build_dir)
from ..spec import (describe_qgemv, describe_qmatmul, describe_qmatmul_grouped,
                    plan_qgemv, plan_qmatmul)

SOURCES = (Path(__file__).resolve().parent / "csrc" / "qmatmul.cu",)

# Kernel launches since the last reset_launches(): one per launch that the
# CUDA runtime accepted.
LAUNCHES = {"qgemv": 0, "qmatmul": 0, "qmatmul_grouped": 0}
# The same launches by body (spec.plan_qmatmul, spec.plan_qgemv): "tc" and
# "simt" the tiles on tensor and CUDA cores, "gemv_tc" and "gemv" the
# decode bodies (M <= 8) on tensor and CUDA cores.
BODY_LAUNCHES = {"qgemv": {"gemv_tc": 0, "gemv": 0},
                 "qmatmul": {"tc": 0, "simt": 0},
                 "qmatmul_grouped": {"tc": 0, "simt": 0, "gemv_tc": 0, "gemv": 0}}
_BODY_CODE = {"simt": 0, "tc": 1, "gemv": 2, "gemv_tc": 3}
_TILE_CODE = {"short": 0, "wide": 1, "dec16": 2, "dec128": 3}

# Set by load_library(): library path, whether it was compiled in this
# process, build seconds and the compiler's register/spill report.
BUILD_INFO: dict = {}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for bodies in BODY_LAUNCHES.values():
        for b in bodies:
            bodies[b] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = build_library("qmatmul", SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # ..., bits, vec, then the plan: body, tile, split, shared-memory bytes
    lib.qmatmul_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                   i32, i32, i32, i32, ptr]
    lib.qmatmul_launch.restype = i32
    lib.qmatmul_grouped_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                           i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.qmatmul_grouped_launch.restype = i32
    lib.qmm_error_string.argtypes = [i32]
    lib.qmm_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


def _check_operands(name: str, x: torch.Tensor, w_packed: torch.Tensor,
                    scales: torch.Tensor) -> None:
    for t, what, dtype in ((x, "x", torch.float32),
                           (w_packed, "w_packed", torch.int8),
                           (scales, "scales", torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {what} lies on {t.device}; the CUDA "
                             f"kernel takes CUDA tensors")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} {tuple(t.shape)} is not contiguous")
    if not (x.device == w_packed.device == scales.device):
        raise ValueError(f"{name}: operands on different devices: x "
                         f"{x.device}, w_packed {w_packed.device}, scales "
                         f"{scales.device}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x with a 16-byte aligned base (the kernels read it in vectors)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _wvec(w_packed: torch.Tensor, n: int) -> int:
    """Widest copy of a packed row's pieces that N and the codes' base
    allow: 16, 4 or 1 bytes."""
    p = w_packed.data_ptr()
    return 16 if n % 16 == 0 and p % 16 == 0 else 4 if n % 4 == 0 and p % 4 == 0 else 1


def _plan_args(plan) -> tuple[int, int, int, int]:
    return (_BODY_CODE[plan.body], _TILE_CODE.get(plan.tile, 0), plan.split,
            plan.smem)


def _launched(lib, name: str, err: int, body: str | None = None) -> None:
    if err != 0:
        msg = lib.qmm_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    if body is not None:
        BODY_LAUNCHES[name][body] += 1


def qgemv(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor, *,
          bits: int) -> torch.Tensor:
    """Decode GEMV on the card: x (M <= 8, K) f32 @ dequant(w_packed
    (K*bits/8, N) int8, scales (G, N) f32) -> (M, N) f32; the body and tile
    from ``spec.plan_qgemv`` (not from M)."""
    sp = describe_qgemv(tuple(x.shape), tuple(w_packed.shape),
                        tuple(scales.shape), bits=bits)
    _check_operands("qgemv", x, w_packed, scales)
    plan = plan_qgemv(sp["K"], sp["N"], sp["G"], bits)
    lib = load_library()
    x = _aligned(x)
    out = torch.empty((sp["M"], sp["N"]), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qmatmul_grouped_launch(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), 1, sp["M"], sp["K"], sp["N"], sp["G"], bits,
            _wvec(w_packed, sp["N"]), *_plan_args(plan), stream)
    _launched(lib, "qgemv", err, plan.body)
    return out


def qmatmul(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor, *,
            bits: int) -> torch.Tensor:
    """Prefill GEMM on the card: x (M, K) f32 @ dequant(w_packed, scales)
    -> (M, N) f32, ragged M and N masked in the kernel; the body, tile and
    split of K from ``spec.plan_qmatmul``."""
    sp = describe_qmatmul(tuple(x.shape), tuple(w_packed.shape),
                          tuple(scales.shape), bits=bits)
    _check_operands("qmatmul", x, w_packed, scales)
    plan = plan_qmatmul(sp["M"], sp["K"], sp["N"], sp["G"], bits)
    lib = load_library()
    x = _aligned(x)
    out = torch.empty((sp["M"], sp["N"]), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qmatmul_launch(x.data_ptr(), w_packed.data_ptr(),
                                 scales.data_ptr(), out.data_ptr(), sp["M"],
                                 sp["K"], sp["N"], sp["G"], bits,
                                 _wvec(w_packed, sp["N"]), *_plan_args(plan), stream)
    _launched(lib, "qmatmul", err, plan.body)
    return out


def qmatmul_grouped(x: torch.Tensor, w_packed: torch.Tensor,
                    scales: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Stacked-expert GEMM on the card: x (E, M, K) f32 @ dequant(w_packed
    (E, K*bits/8, N) int8, scales (E, G, N) f32) -> (E, M, N) f32, any M,
    ragged M and N masked in the kernel; the body from
    ``spec.plan_qmatmul(..., grouped=True)`` (M <= 8: ``plan_qgemv``)."""
    sp = describe_qmatmul_grouped(tuple(x.shape), tuple(w_packed.shape),
                                  tuple(scales.shape), bits=bits)
    _check_operands("qmatmul_grouped", x, w_packed, scales)
    plan = plan_qmatmul(sp["M"], sp["K"], sp["N"], sp["G"], bits, sp["E"], True)
    lib = load_library()
    x = _aligned(x)
    out = torch.empty((sp["E"], sp["M"], sp["N"]), dtype=torch.float32,
                      device=x.device)
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qmatmul_grouped_launch(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), sp["E"], sp["M"], sp["K"], sp["N"], sp["G"], bits,
            _wvec(w_packed, sp["N"]), *_plan_args(plan), stream)
    _launched(lib, "qmatmul_grouped", err, plan.body)
    return out
