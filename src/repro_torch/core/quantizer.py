"""Sub-byte packing of integer codes (the deployment format).

Only the packing half of the JAX package's quantizer is ported in this
slice; QConfig/QState and fake-quant come with calibration.

Layout (offset-binary, shared bit for bit with ``repro.core.quantizer``):
codes are packed ``per = 8 // bits`` to a byte along ``axis``; field
``i`` of packed row ``r`` holds row ``r * per + i`` at shift ``bits * i``
and stores ``code + 2**(bits - 1)``, so unpacking is mask and shift only.
"""
from __future__ import annotations

import torch


def pack_int(q: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack integer codes along ``axis`` into an int8 container.

    int8 -> identity; int4 -> 2 values/byte; int2 -> 4 values/byte.
    """
    if bits == 8:
        return q.to(torch.int8)
    per = 8 // bits
    axis = axis % q.ndim
    if q.shape[axis] % per:
        raise ValueError(f"axis {axis} of codes {tuple(q.shape)} is not a "
                         f"multiple of {per} ({bits}-bit packing)")
    off = (q.to(torch.int32) + 2 ** (bits - 1)).to(torch.uint8)
    off = off.reshape(*q.shape[:axis], q.shape[axis] // per, per,
                      *q.shape[axis + 1:])
    out = torch.zeros_like(off.select(axis + 1, 0))
    for i in range(per):
        out |= off.select(axis + 1, i) << (bits * i)
    return out.view(torch.int8)


def unpack_int(p: torch.Tensor, bits: int, rows: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int`: int8 codes with ``rows`` along ``axis``."""
    if bits == 8:
        return p.to(torch.int8)
    per = 8 // bits
    axis = axis % p.ndim
    mask = (1 << bits) - 1
    u = p.contiguous().view(torch.uint8)
    parts = [((u >> (bits * i)) & mask).to(torch.int32) - 2 ** (bits - 1)
             for i in range(per)]
    out = torch.stack(parts, dim=axis + 1)
    out = out.reshape(*p.shape[:axis], rows, *p.shape[axis + 1:])
    return out.to(torch.int8)
