"""The work of each kernel wrapper's call, reported to an optional recorder.

The hand-written kernels are ``ctypes`` calls, which no dispatch mode
sees. So each public wrapper (``qmatmul/ops.py::qmm``,
``kvattn/ops.py::attend_int8`` and ``attend_int8_paged``,
``fakequant/ops.py::adaround_forward``) reports every call here, whichever
implementation runs it: the kernel on the card, or the plain version. The
recorder (``analysis/optrace.py``) adds the call's :class:`Work`, and
leaves out the ATen ops of the plain version inside it, so a step's
summary reads the same work on both paths.

Each input is read once and the output written once; FLOPs are the dots'
``2 * M * K * N`` (attention: the two dots of every query row against every
slot), and the element-wise fake-quant forward has none, as the reference
counts none. ``chip_smoke.py``'s qmm and fakequant bounds take their bytes
from :func:`qmm_work` and :func:`fq_work`; its attention bound charges only
the slots that the run's positions make valid, where :func:`kv_work` charges
every slot.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Work:
    """One wrapper call: its kernel, its dot FLOPs, the bytes it moves and,
    of those, the packed weight bytes (codes and scales) it reads."""

    kernel: str
    flops: float
    bytes: float
    weight_bytes: float = 0.0


# A callable taking a Work and returning a context manager around the call,
# or None (the default: nothing is recorded and nothing is computed).
_RECORDER: Optional[Callable[[Work], contextlib.AbstractContextManager]] = None
_NULL = contextlib.nullcontext()


def set_recorder(recorder) -> Optional[Callable]:
    """Install ``recorder`` (None removes it); returns the one it replaces."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, recorder
    return prev


def call(work: Callable[..., Work], *dims):
    """The context a wrapper runs one call in: ``work(*dims)`` is computed
    and recorded only when a recorder is installed."""
    if _RECORDER is None:
        return _NULL
    return _RECORDER(work(*dims))


def qmm_work(kernel: str, e: int, m: int, k: int, n: int, bits: int, g: int) -> Work:
    """x (E, M, K) f32 @ codes (E, K*bits/8, N) int8 + scales (E, G, N) f32
    -> (E, M, N) f32."""
    weight = e * (k * n * bits // 8 + g * n * 4)
    return Work(kernel, 2.0 * e * m * k * n, weight + e * (m * k * 4 + m * n * 4), weight)


def kv_work(kernel: str, b: int, h: int, kh: int, hd: int, s: int, q_bytes: int,
            index_bytes: int, scale_bytes: int) -> Work:
    """q (B, H, hd) against S int8 K and V slots of ``kh`` heads with their
    scales, indexed by kpos (B, S) or block tables; cur (B,); out (B, H, hd)."""
    nbytes = (2 * b * h * hd * q_bytes + b * 4 + index_bytes
              + 2 * b * s * kh * (hd + scale_bytes))
    return Work(kernel, 4.0 * b * h * s * hd, nbytes)


def fq_work(k: int, n: int, s_rows: int) -> Work:
    """w and v (K, N) f32 and the (s_rows, N) scale read once, (K, N) f32
    written once."""
    return Work("fakequant", 0.0, 4.0 * (3 * k * n + s_rows * n))
