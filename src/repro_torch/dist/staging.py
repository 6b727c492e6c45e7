"""A collective staged through pinned host memory, for gloo on CUDA tensors.

DTensor reaches the process group through the functional collectives
(``torch.ops._c10d_functional.*``). In torch 2.11 the gloo backend runs
the functional ``all_gather_into_tensor`` on CUDA tensors into a crash,
while it takes the other collectives DTensor calls
(``scripts/dist_probe.py`` finds which). :func:`stage_through_host`
replaces that op's CUDA kernel by one that copies the operand to pinned
host memory, runs the same all-gather there with ``torch.distributed`` on
the same group, and copies the result back to the operand's device. Only
the collective's bytes cross to the host; no computation does. ``STAGED``
counts each staged call by op, so the caller can print what went through
the host. A torch that needs another op staged needs its implementation
here first: :func:`stage_through_host` raises on any other name.
"""
from __future__ import annotations

import collections

import torch

STAGED: collections.Counter = collections.Counter()
_LIBS: list = []  # the registrations live as long as the process


def _all_gather_into_tensor(input, group_size, group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    h = torch.empty(input.shape, dtype=input.dtype, pin_memory=True).copy_(input)
    out = torch.empty((group_size * h.shape[0], *h.shape[1:]), dtype=h.dtype,
                      pin_memory=True)
    dist.all_gather_into_tensor(out, h, group=_resolve_process_group(group_name))
    STAGED["all_gather_into_tensor"] += 1
    return out.to(input.device)


OPS = {"all_gather_into_tensor": _all_gather_into_tensor}


def stage_through_host(ops) -> None:
    """Run each functional collective in ``ops`` (names from :data:`OPS`)
    on CUDA tensors through pinned host memory, in this process."""
    if not ops:
        return
    missing = [op for op in ops if op not in OPS]
    if missing:
        raise ValueError(f"no host-staged version of {missing}; staged: {list(OPS)}")
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for op in ops:
        lib.impl(op, OPS[op], "CUDA")
    _LIBS.append(lib)
