"""CUDA fused AdaRound forward for Hopper: build, binding, launch.

``fakequant`` in ``csrc/fakequant.cu`` replaces the JAX package's Pallas
TPU kernel ``src/repro/kernels/fakequant/kernel.py::fakequant``. It is an
elementwise pass bound by bytes: one read of ``w`` and ``v``, one of the
scale row, and one write of the output (12 bytes per weight against a
handful of f32 operations). A grid-stride loop reads 16-byte vectors where
N allows and masks nothing else: the element count need not divide the
block. The division ``w / s`` is IEEE (``__fdiv_rn``), so the hardened
forward is bit-identical to the plain ``core.adaround.hard_quant``, whose
codes ``deploy.export`` recovers from the baked weights.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use through
``kernels/build.py`` and bound through ``ctypes``; nothing is built when
this module is imported. The wrapper checks device, dtype, shape and
contiguity, allocates its output, launches on the current stream, raises
if the launch was refused and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_library, on_device
from ..spec import describe_fakequant

SOURCES = (Path(__file__).resolve().parent / "csrc" / "fakequant.cu",)

# Kernel launches since the last reset_launches(): one per launch that the
# CUDA runtime accepted.
LAUNCHES = {"fakequant": 0}
# The same launches by the weight's rank: a 2-D (K, N) weight, or a stack
# of experts (E, K, N) run as its (E*K, N) view.
VIEW_LAUNCHES = {"2d": 0, "experts": 0}

# Set by load_library(): library path, whether it was compiled in this
# process, build seconds and the compiler's register/spill report.
BUILD_INFO: dict = {}

_LIB = None


def reset_launches() -> None:
    for counts in (LAUNCHES, VIEW_LAUNCHES):
        for k in counts:
            counts[k] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = build_library("fakequant", SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fakequant_launch.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.fakequant_launch.restype = i32
    lib.fakequant_error_string.argtypes = [i32]
    lib.fakequant_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


def fakequant(w: torch.Tensor, v: torch.Tensor, scale: torch.Tensor, *,
              qmin: int, qmax: int, hard: bool) -> torch.Tensor:
    """AdaRound forward on the card: w, v (K, N) f32 and scale (1, N) or
    (K, N) f32 -> ``clip(floor(w / s) + h, qmin, qmax) * s`` (K, N) f32.
    A stack w, v (..., K, N) with a (1, N) scale runs as its (prod(...)*K,
    N) view and returns the stack's shape."""
    for what, t in (("w", w), ("v", v), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"fakequant: {what} lies on {t.device}; the CUDA "
                             f"kernel takes CUDA tensors")
        if t.device != w.device:
            raise ValueError(f"fakequant: {what} lies on {t.device}, w on {w.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fakequant: {what} is {t.dtype}, expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"fakequant: {what} {tuple(t.shape)} is not contiguous")
    if v.shape != w.shape:
        raise ValueError(f"fakequant: v {tuple(v.shape)} does not match w "
                         f"{tuple(w.shape)}")
    shape = w.shape
    if w.ndim > 2 and scale.shape[0] == 1:  # a stack: its (prod(...)*K, N) view
        w, v = w.view(-1, shape[-1]), v.view(-1, shape[-1])
    sp = describe_fakequant(w.shape, scale.shape)
    lib = load_library()
    out = torch.empty_like(w)
    with on_device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fakequant_launch(
            w.data_ptr(), v.data_ptr(), scale.data_ptr(), out.data_ptr(),
            sp["K"], sp["N"], scale.shape[0], int(qmin), int(qmax), int(hard),
            stream)
    if err != 0:
        msg = lib.fakequant_error_string(err).decode()
        raise RuntimeError(f"fakequant kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["fakequant"] += 1
    VIEW_LAUNCHES["experts" if len(shape) > 2 else "2d"] += 1
    return out.reshape(shape)
