"""Request-level serving over a packed :class:`~repro_torch.deploy.QuantizedArtifact`.

Slot-based continuous batching with a paged KV cache: new prompts are
admitted into freed decode slots, prefill runs in chunks interleaved
with decode ticks, and KV lives in per-layer page pools (int8 codes +
scales read by the ``kv_decode`` kernel, or float reference mode) indexed
by one block table per stream. Admission overcommit + preemption,
per-request deadlines, per-stream fault isolation and graceful drain
make the engine survive pressure instead of refusing it. The port of the
JAX package's ``repro.serve_engine``.
"""
from .engine import (ACTIVE_STATES, TERMINAL_STATES, EngineConfig,
                     EngineStalledError, Request, RequestRejected,
                     RequestState, ServeEngine)
from .pages import PagePool, PagePoolExhausted

__all__ = ["ACTIVE_STATES", "TERMINAL_STATES", "EngineConfig",
           "EngineStalledError", "PagePool", "PagePoolExhausted", "Request",
           "RequestRejected", "RequestState", "ServeEngine"]
