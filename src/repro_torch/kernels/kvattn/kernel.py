"""CUDA int8-KV decode attention for Hopper: build, binding, launch.

``kv_decode`` in ``csrc/kvattn.cu`` replaces the JAX package's Pallas TPU
kernel ``src/repro/kernels/kvattn/kernel.py::kv_decode``. It is bound by
bytes (int8 K/V plus scales); the blocks of one (batch, kv-head) read each
K/V byte once for all G = H/K query rows. S is split over a thread-block
cluster, and within a block over its warps: each warp runs an f32 online
softmax over its own tiles of 32 slots streamed through its own
two-stage ``cp.async`` ring; warps merge in warp order through shared memory, blocks
in rank order through distributed shared memory. The ragged tail is masked
in the kernel, so any S works. ``spec.plan_kv_decode`` picks the split,
the warps and the query rows a block keeps from the shapes. Two bodies, chosen from the head dim by
``spec.kv_decode_body``: 16-byte loads of codes for hd % 16 == 0 ("v16"),
8-byte loads for the other multiples of 8 ("v8", e.g. hd 120).

Two entries of the one body: :func:`kv_decode` over dense (B, S, K, hd)
caches, the direct counterpart of the JAX kernel, and
:func:`kv_decode_paged` over the serve engine's page pool, read through
the block tables (no gathered view).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use through
``kernels/build.py`` and bound through ``ctypes``; nothing is built when
this module is imported. The wrappers check device, dtype, shape,
contiguity and the alignment of the codes to the body's loads, allocate
the output, launch on the current stream, raise if the launch was refused
and count the launch in :data:`LAUNCHES` (every launch), and by body, entry
and split in :data:`BODY_LAUNCHES`, :data:`ENTRY_LAUNCHES` and
:data:`SPLIT_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_library, on_device
from ..spec import (KV_BODIES, KV_SPLITS, KvPlan, describe_kv_decode,
                    describe_kv_decode_paged, kv_smem, plan_kv_decode)

SOURCES = (Path(__file__).resolve().parent / "csrc" / "kvattn.cu",)

# Kernel launches since the last reset_launches(): one per launch that the
# CUDA runtime accepted, from either entry.
LAUNCHES = {"kv_decode": 0}
# The same launches by body (spec.kv_decode_body), by entry, and by the
# plan's split of S.
BODY_LAUNCHES = {"kv_decode": {b: 0 for b in KV_BODIES}}
ENTRY_LAUNCHES = {"kv_decode": {"dense": 0, "paged": 0}}
SPLIT_LAUNCHES = {"kv_decode": {s: 0 for s in KV_SPLITS}}

# Set by load_library(): library path, whether it was compiled in this
# process, build seconds and the compiler's register/spill report.
BUILD_INFO: dict = {}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in (BODY_LAUNCHES, ENTRY_LAUNCHES, SPLIT_LAUNCHES):
        for by in counts.values():
            for b in by:
                by[b] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = build_library("kvattn", SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kv_decode_launch.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
    lib.kv_decode_launch.restype = i32
    lib.kv_decode_paged_launch.argtypes = [ptr] * 8 + [i32] * 14 + [ptr]
    lib.kv_decode_paged_launch.restype = i32
    lib.kvattn_error_string.argtypes = [i32]
    lib.kvattn_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


def _check_operands(entry: str, named, q: torch.Tensor) -> None:
    dev = q.get_device()
    for what, t, dtype in named:
        if not t.is_cuda:
            raise ValueError(f"{entry}: {what} lies on {t.device}; the CUDA "
                             f"kernel takes CUDA tensors")
        if t.dtype != dtype:
            raise TypeError(f"{entry}: {what} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: {what} {tuple(t.shape)} is not contiguous")
        if t.get_device() != dev:
            raise ValueError(f"{entry}: {what} lies on {t.device}, q on {q.device}")


def _check_aligned(entry: str, sp: dict, named) -> int:
    vb = KV_BODIES[sp["body"]]
    for what, t in named:
        if t.data_ptr() % vb:
            raise ValueError(f"{entry}: {what} is not {vb}-byte aligned; the "
                             f"kernel reads the codes in {vb}-byte vectors at "
                             f"hd={sp['hd']}")
    return vb


def _plan(entry: str, sp: dict, plan) -> KvPlan:
    if plan is None:
        return plan_kv_decode(sp["B"], sp["K"], sp["S"], sp["hd"], sp["G"])
    if plan.body != sp["body"]:
        raise ValueError(f"{entry}: plan body {plan.body} does not fit hd={sp['hd']} "
                         f"({sp['body']})")
    return plan


def _plan_ints(plan: KvPlan) -> tuple:
    return plan.warps, plan.split, plan.rows, plan.units


def _window(entry: str, window) -> int:
    if window is not None and window < 1:
        raise ValueError(f"{entry}: window={window} must be >= 1 or None")
    return -1 if window is None else int(window)


def _count(entry: str, sp: dict, plan: KvPlan, err: int, lib) -> None:
    if err != 0:
        msg = lib.kvattn_error_string(err).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["kv_decode"] += 1
    BODY_LAUNCHES["kv_decode"][sp["body"]] += 1
    ENTRY_LAUNCHES["kv_decode"]["paged" if entry == "kv_decode_paged" else "dense"] += 1
    SPLIT_LAUNCHES["kv_decode"][plan.split] += 1


def kv_decode(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
              kscale: torch.Tensor, vscale: torch.Tensor, kpos: torch.Tensor,
              cur_pos: torch.Tensor, *, window=None, plan: KvPlan = None) -> torch.Tensor:
    """Decode attention on the card: q (B, H, hd) f32 over k8/v8 (B, S, K,
    hd) int8 with f32 scales (B, S, K), kpos (B, S) and cur_pos (B,) int32
    -> (B, H, hd) f32. ``window`` (>= 1) masks slots with
    ``cur - kpos >= window``; ``None`` is full causal. ``plan`` replaces
    ``spec.plan_kv_decode``'s (a test or probe of another plan)."""
    entry = "kv_decode"
    sp = describe_kv_decode(q.shape, k8.shape, v8.shape, kscale.shape,
                            vscale.shape, kpos.shape, cur_pos.shape)
    _check_operands(entry, (("q", q, torch.float32), ("k8", k8, torch.int8),
                            ("v8", v8, torch.int8), ("kscale", kscale, torch.float32),
                            ("vscale", vscale, torch.float32),
                            ("kpos", kpos, torch.int32), ("cur_pos", cur_pos, torch.int32)), q)
    vb = _check_aligned(entry, sp, (("k8", k8), ("v8", v8)))
    win = _window(entry, window)
    plan = _plan(entry, sp, plan)
    smem = kv_smem(plan.rows, sp["hd"], plan.warps)
    lib = load_library()
    out = torch.empty((sp["B"], sp["H"], sp["hd"]), dtype=torch.float32, device=q.device)
    with on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kv_decode_launch(
            q.data_ptr(), k8.data_ptr(), v8.data_ptr(), kscale.data_ptr(),
            vscale.data_ptr(), kpos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
            sp["B"], sp["H"], sp["K"], sp["S"], sp["hd"], win, vb, *_plan_ints(plan),
            smem, stream)
    _count(entry, sp, plan, err, lib)
    return out


def kv_decode_paged(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor,
                    block_tables: torch.Tensor, cur_pos: torch.Tensor, *,
                    page_size: int, window=None, plan: KvPlan = None) -> torch.Tensor:
    """Decode attention on the card over the serve engine's int8 page pool,
    read through the block tables: q (B, H, hd) f32; codes k_pages/v_pages
    (num_pages, page_size, K, hd) int8; scales (num_pages, page_size, K)
    float16; block_tables (B, max_pages) int32, -1 for an unallocated page
    (read as page 0 and masked), else a page below num_pages; cur_pos (B,)
    int32 -> (B, H, hd) f32. Computes :func:`kv_decode` on the view that
    ``ref.paged_view`` would gather (S = max_pages * page_size,
    kpos = t where the slot's page is allocated, -1 elsewhere) with the
    scales widened to f32, bit for bit, under the same plan."""
    entry = "kv_decode_paged"
    sp = describe_kv_decode_paged(q.shape, k_pages.shape, v_pages.shape, k_scale.shape,
                                  v_scale.shape, block_tables.shape, cur_pos.shape,
                                  page_size)
    _check_operands(entry, (("q", q, torch.float32), ("k_pages", k_pages, torch.int8),
                            ("v_pages", v_pages, torch.int8),
                            ("k_scale", k_scale, torch.float16),
                            ("v_scale", v_scale, torch.float16),
                            ("block_tables", block_tables, torch.int32),
                            ("cur_pos", cur_pos, torch.int32)), q)
    vb = _check_aligned(entry, sp, (("k_pages", k_pages), ("v_pages", v_pages)))
    for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.data_ptr() % 4:
            raise ValueError(f"{entry}: {what} is not 4-byte aligned; the kernel "
                             f"copies the f16 scales in 32-bit words")
    win = _window(entry, window)
    plan = _plan(entry, sp, plan)
    smem = kv_smem(plan.rows, sp["hd"], plan.warps, page_size)
    lib = load_library()
    out = torch.empty((sp["B"], sp["H"], sp["hd"]), dtype=torch.float32, device=q.device)
    with on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kv_decode_paged_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), block_tables.data_ptr(), cur_pos.data_ptr(),
            out.data_ptr(), sp["B"], sp["H"], sp["K"], sp["pages"], page_size,
            sp["max_pages"], sp["hd"], win, vb, *_plan_ints(plan), smem, stream)
    _count(entry, sp, plan, err, lib)
    return out
