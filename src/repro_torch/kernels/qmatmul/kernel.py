"""CUDA packed dequant-matmul kernels for Hopper: build, binding, launch.

Three hand-written kernels in ``csrc/qmatmul.cu`` replace the JAX
package's Pallas TPU kernels (``src/repro/kernels/qmatmul/kernel.py``):

  qgemv    replaces ``kernel.py::qgemv`` (decode, M <= 8 rows). Under 1 MB
           of packed weight per call, so parallelism and latency are its
           limit: a cluster of 8 blocks splits K for each 64-column strip
           and is summed through distributed shared memory; 32-bit loads
           of packed bytes are unpacked in registers and each group's scale
           multiplies its partial sum.
  qmatmul  replaces ``kernel.py::qmatmul`` (prefill GEMM). Bound by f32
           operations at M = 512: 64 x 64 output tiles stage x and the
           unpacked, scaled weight tile through shared memory over K, with
           the next k-step's loads in flight during the math.
  qmatmul_grouped  replaces ``kernel.py::qmatmul_grouped`` (stacked MoE
           experts, x (E, M, K) @ (E, K*bits/8, N) codes). Bound by f32
           operations at the serving shapes (E 64, M 8 or 64), each call
           streaming ~92 MB of codes: M <= 8 runs one block per (expert,
           64 columns) fed by a 4-stage cp.async ring, more rows take
           qmatmul's tile; the expert is on the grid and its operands are
           found by offsets into the stacked codes, so no (E, K, N)
           dequantized copy exists.

All mask ragged M and N, so the TPU-only padding of ``ops._qmm_2d`` does
not exist here. The library is compiled with ``nvcc`` for ``sm_90a`` at
first use, from the sources beside this file, through ``kernels/build.py``
(``build/kernels/`` at the repository root, keyed by a hash of the sources
and flags), and bound through ``ctypes``. Nothing is built when this
module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output, launches on the current stream, raises if the launch was refused
and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_dir, build_library, on_device  # noqa: F401 (build_dir)
from ..spec import describe_qgemv, describe_qmatmul, describe_qmatmul_grouped

SOURCES = (Path(__file__).resolve().parent / "csrc" / "qmatmul.cu",)

# Kernel launches since the last reset_launches(): one per launch that the
# CUDA runtime accepted.
LAUNCHES = {"qgemv": 0, "qmatmul": 0, "qmatmul_grouped": 0}

# Set by load_library(): library path, whether it was compiled in this
# process, build seconds and the compiler's register/spill report.
BUILD_INFO: dict = {}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = build_library("qmatmul", SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qgemv_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.qgemv_launch.restype = i32
    lib.qmatmul_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.qmatmul_launch.restype = i32
    lib.qmatmul_grouped_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                           i32, i32, i32, ptr]
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


def _vec(w_packed: torch.Tensor, n: int) -> int:
    """Whether 4 packed bytes of a row can be read as one 32-bit word."""
    return int(n % 4 == 0 and w_packed.data_ptr() % 4 == 0)


def _launched(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.qmm_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


def qgemv(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor, *,
          bits: int) -> torch.Tensor:
    """Decode GEMV on the card: x (M <= 8, K) f32 @ dequant(w_packed
    (K*bits/8, N) int8, scales (G, N) f32) -> (M, N) f32."""
    sp = describe_qgemv(tuple(x.shape), tuple(w_packed.shape),
                        tuple(scales.shape), bits=bits)
    _check_operands("qgemv", x, w_packed, scales)
    lib = load_library()
    x = _aligned(x)
    out = torch.empty((sp["M"], sp["N"]), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qgemv_launch(x.data_ptr(), w_packed.data_ptr(),
                               scales.data_ptr(), out.data_ptr(), sp["M"],
                               sp["K"], sp["N"], sp["G"], bits,
                               _vec(w_packed, sp["N"]), stream)
    _launched(lib, "qgemv", err)
    return out


def qmatmul(x: torch.Tensor, w_packed: torch.Tensor, scales: torch.Tensor, *,
            bits: int) -> torch.Tensor:
    """Prefill GEMM on the card: x (M, K) f32 @ dequant(w_packed, scales)
    -> (M, N) f32, ragged M and N masked in the kernel."""
    sp = describe_qmatmul(tuple(x.shape), tuple(w_packed.shape),
                          tuple(scales.shape), bits=bits)
    _check_operands("qmatmul", x, w_packed, scales)
    lib = load_library()
    x = _aligned(x)
    out = torch.empty((sp["M"], sp["N"]), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qmatmul_launch(x.data_ptr(), w_packed.data_ptr(),
                                 scales.data_ptr(), out.data_ptr(), sp["M"],
                                 sp["K"], sp["N"], sp["G"], bits,
                                 _vec(w_packed, sp["N"]), stream)
    _launched(lib, "qmatmul", err)
    return out


def qmatmul_grouped(x: torch.Tensor, w_packed: torch.Tensor,
                    scales: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Stacked-expert GEMM on the card: x (E, M, K) f32 @ dequant(w_packed
    (E, K*bits/8, N) int8, scales (E, G, N) f32) -> (E, M, N) f32, any M,
    ragged M and N masked in the kernel."""
    sp = describe_qmatmul_grouped(tuple(x.shape), tuple(w_packed.shape),
                                  tuple(scales.shape), bits=bits)
    _check_operands("qmatmul_grouped", x, w_packed, scales)
    lib = load_library()
    x = _aligned(x)
    out = torch.empty((sp["E"], sp["M"], sp["N"]), dtype=torch.float32,
                      device=x.device)
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qmatmul_grouped_launch(
            x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), sp["E"], sp["M"], sp["K"], sp["N"], sp["G"], bits,
            _vec(w_packed, sp["N"]), stream)
    _launched(lib, "qmatmul_grouped", err)
    return out
