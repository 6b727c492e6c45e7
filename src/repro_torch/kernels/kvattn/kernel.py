"""CUDA int8-KV decode attention for Hopper: build, binding, launch.

``kv_decode`` in ``csrc/kvattn.cu`` replaces the JAX package's Pallas TPU
kernel ``src/repro/kernels/kvattn/kernel.py::kv_decode``. It is bound by
bytes (int8 K/V plus scales); one block per (batch, kv-head) reads each
K/V byte once for all G = H/K query rows, streaming S through shared
memory in tiles of 256 slots with an f32 online softmax. The sequential S
grid of the TPU kernel becomes that loop; the ragged tail is masked in the
kernel, so any S works. Two bodies, chosen from the head dim by
``spec.kv_decode_body``: 16-byte loads of codes for hd % 16 == 0 ("v16"),
8-byte loads for the other multiples of 8 ("v8", e.g. hd 120).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use through
``kernels/build.py`` and bound through ``ctypes``; nothing is built when
this module is imported. The wrapper checks device, dtype, shape,
contiguity and the alignment of the codes to the body's loads, allocates
its output, launches on the current stream, raises if the launch was
refused and counts the launch in :data:`LAUNCHES` and
:data:`BODY_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_library, on_device
from ..spec import KV_BODIES, describe_kv_decode

SOURCES = (Path(__file__).resolve().parent / "csrc" / "kvattn.cu",)

# Kernel launches since the last reset_launches(): one per launch that the
# CUDA runtime accepted.
LAUNCHES = {"kv_decode": 0}
# The same launches by body (spec.kv_decode_body).
BODY_LAUNCHES = {"kv_decode": {b: 0 for b in KV_BODIES}}

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
    lib, info = build_library("kvattn", SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kv_decode_launch.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.kv_decode_launch.restype = i32
    lib.kvattn_error_string.argtypes = [i32]
    lib.kvattn_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


_OPERANDS = (("q", torch.float32), ("k8", torch.int8), ("v8", torch.int8),
             ("kscale", torch.float32), ("vscale", torch.float32),
             ("kpos", torch.int32), ("cur_pos", torch.int32))


def kv_decode(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
              kscale: torch.Tensor, vscale: torch.Tensor, kpos: torch.Tensor,
              cur_pos: torch.Tensor, *, window=None) -> torch.Tensor:
    """Decode attention on the card: q (B, H, hd) f32 over k8/v8 (B, S, K,
    hd) int8 with f32 scales (B, S, K), kpos (B, S) and cur_pos (B,) int32
    -> (B, H, hd) f32. ``window`` (>= 1) masks slots with
    ``cur - kpos >= window``; ``None`` is full causal."""
    sp = describe_kv_decode(q.shape, k8.shape, v8.shape, kscale.shape,
                            vscale.shape, kpos.shape, cur_pos.shape)
    ts = (q, k8, v8, kscale, vscale, kpos, cur_pos)
    for t, (what, dtype) in zip(ts, _OPERANDS):
        if t.device.type != "cuda":
            raise ValueError(f"kv_decode: {what} lies on {t.device}; the CUDA "
                             f"kernel takes CUDA tensors")
        if t.dtype != dtype:
            raise TypeError(f"kv_decode: {what} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"kv_decode: {what} {tuple(t.shape)} is not contiguous")
        if t.device != q.device:
            raise ValueError(f"kv_decode: {what} lies on {t.device}, q on {q.device}")
    vb = KV_BODIES[sp["body"]]
    for what, t in (("k8", k8), ("v8", v8)):
        if t.data_ptr() % vb:
            raise ValueError(f"kv_decode: {what} is not {vb}-byte aligned; the "
                             f"kernel reads the codes in {vb}-byte vectors at "
                             f"hd={sp['hd']}")
    if window is not None and window < 1:
        raise ValueError(f"kv_decode: window={window} must be >= 1 or None")
    lib = load_library()
    out = torch.empty((sp["B"], sp["H"], sp["hd"]), dtype=torch.float32,
                      device=q.device)
    with on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kv_decode_launch(
            q.data_ptr(), k8.data_ptr(), v8.data_ptr(), kscale.data_ptr(),
            vscale.data_ptr(), kpos.data_ptr(), cur_pos.data_ptr(),
            out.data_ptr(), sp["B"], sp["H"], sp["K"], sp["S"], sp["hd"],
            -1 if window is None else int(window), vb, stream)
    if err != 0:
        msg = lib.kvattn_error_string(err).decode()
        raise RuntimeError(f"kv_decode kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["kv_decode"] += 1
    BODY_LAUNCHES["kv_decode"][sp["body"]] += 1
    return out
