"""The serve engine's two programs, replayed from CUDA graphs on the card.

A program is a callable ``(params, tokens, cache, pos, bt) -> (logits,
cache)``: the engine's ``decode_fn`` or ``chunk_fn``. Run eagerly, each call
enqueues several hundred launches from the host, one op at a time. On the
card the engine captures each program once, against its own params and KV
pool, and a call then copies the new tokens, positions and block tables
into the graph's static inputs and replays it: one launch. The static
logits are handed back as they are; the engine reads them before the next
replay.

Capture is sound only for a program that writes its cache in place: the
graph writes the very tensors it captured, so a program that returned a
new cache leaf would leave the engine's pool stale. :func:`writes_in_place`
tells that from the warm-up call's output against the leaves it was
handed; a program that fails it stays eager.

A replay reports what its eager call would. The ``(work, dims)`` of every
call the kernel wrappers hand ``kernels/record.py::call`` during the
capture are handed to ``record.call`` again on each replay, in order, each
context entered and left at once (``call`` is looked up on the module each
time, so whatever stands in for it sees them). The kernels' launch and
tier counters advance by what the capture launched. The capture itself runs
no kernel, and counts and records nothing.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Optional

import torch

from ..interop import tree_leaves
from ..kernels import record


def writes_in_place(given: list, cache_out) -> bool:
    """Whether every cache leaf a program returned is the very tensor it
    was given. ``given`` is ``tree_leaves`` of the cache it was handed,
    taken before the call: a program may hand back the container it was
    given with a new tensor put into it."""
    out = tree_leaves(cache_out)
    return len(given) == len(out) and all(x is y for x, y in zip(given, out))


def launch_counters() -> list[dict]:
    """The flat ``{name: count}`` dicts that the engine's kernel wrappers
    bump on each call: launches, and launches by body, entry and split
    (``kvattn/kernel.py``, ``qmatmul/kernel.py``), and ``qmm``'s tiers."""
    from ..kernels.kvattn import kernel as kv
    from ..kernels.qmatmul import kernel as qk
    from ..kernels.qmatmul import ops as qops

    out = [kv.LAUNCHES, qk.LAUNCHES, qops.TIER_COUNTS]
    for nested in (kv.BODY_LAUNCHES, kv.ENTRY_LAUNCHES, kv.SPLIT_LAUNCHES,
                   qk.BODY_LAUNCHES):
        out.extend(nested.values())
    return out


class Program:
    """One program as the engine calls it: eagerly until :meth:`capture`,
    then by replaying its graph. ``replays`` and ``eager_calls`` count the
    calls each way."""

    def __init__(self, fn):
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = self.eager_calls = 0
        # set by capture(): what the graph was captured against, its static
        # inputs and logits, the wrappers' calls and the launches to count
        self.params = self.cache = None
        self.inputs: tuple = ()
        self.logits = None
        self.calls: list[tuple] = []
        self.launched: list[tuple[dict, str, int]] = []

    def capture(self, params, cache, tokens_shape: tuple, max_pages: int, *,
                stream: torch.cuda.Stream, pool=None) -> None:
        """Capture the program against ``params`` and ``cache`` on
        ``stream`` (warmed by the caller), in the graph memory ``pool``."""
        dev = tree_leaves(cache)[0].device
        b = tokens_shape[0]
        self.inputs = (torch.zeros(tokens_shape, dtype=torch.int32, device=dev),
                       torch.zeros((b,), dtype=torch.int32, device=dev),
                       torch.full((b, max_pages), -1, dtype=torch.int32, device=dev))
        tok, pos, bt = self.inputs
        calls: list[tuple] = []

        def logged(work, *dims):
            calls.append((work, dims))
            return contextlib.nullcontext()

        counters = launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        real, record.call = record.call, logged
        # Python's cyclic collector stays off inside the capture (the
        # capture collects once on entry): an older engine's graph collected
        # there is destroyed, and its memory freed, mid-capture, which a
        # capture cannot take
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                logits, out = self.fn(params, tok, cache, pos, bt)
        finally:
            if collecting:
                gc.enable()
            record.call = real
            after = [dict(c) for c in counters]
            for c, was in zip(counters, before):
                c.update(was)
        self.launched = [(c, k, n - was[k])
                         for c, was, now in zip(counters, before, after)
                         for k, n in now.items() if n != was[k]]
        self.graph, self.logits, self.calls = graph, logits, calls
        self.params, self.cache = params, out

    def __call__(self, params, tokens, cache, pos, bt):
        if self.graph is None:
            self.eager_calls += 1
            return self.fn(params, tokens, cache, pos, bt)
        if params is not self.params or cache is not self.cache:
            raise ValueError("a captured program replays only against the "
                             "params and KV pool it was captured with")
        for static, new in zip(self.inputs, (tokens, pos, bt)):
            static.copy_(new)
        self.graph.replay()
        self.replays += 1
        for work, dims in self.calls:
            with record.call(work, *dims):
                pass
        for c, k, n in self.launched:
            c[k] += n
        return self.logits, self.cache
