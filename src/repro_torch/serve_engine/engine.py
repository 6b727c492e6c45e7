"""Continuous-batching scheduler: slots, chunked prefill, paged decode.

The engine owns ``num_slots`` decode slots and one paged KV pool
(``models.LM.init_paged_cache``). A tick is: expire overdue requests,
admit waiting requests into free slots, advance ONE prefilling stream
by one chunk (round-robin — keeps time-to-first-token bounded without
starving decode), then run one batched decode step over every decoding
slot. Two fixed-shape programs cover everything: a (num_slots, 1) decode
step and a (1, prefill_chunk) prefill step, both the same
``decode_step`` cached path — chunked prefill *is* multi-token decode.
They run eagerly under ``torch.inference_mode()`` and write the KV pool
in place (the JAX package jits them and threads the pool through); on
the card the decode step launches ``kv_decode`` once per layer for an
int8 pool, and the packed ``qgemv``/``qmatmul`` kernels for packed
weights.

Admission is governed by ``EngineConfig.overcommit``:

* ``'none'`` (reference) reserves the worst-case page need
  (``prompt + max_new``) up front, so decode can never hit pool
  exhaustion mid-stream — but most of the pool sits promised-and-empty
  under load.
* ``'prompt'`` reserves only the prompt's pages plus
  ``overcommit_headroom``; decode grows the reservation just-in-time.
  When the pool has nothing left to promise, the scheduler **preempts**
  a victim stream (lowest priority, newest admission): its pages are
  freed and it is re-queued for re-prefill of ``prompt + generated``.
  Greedy decode is deterministic (every kernel sums in a fixed order)
  and chunked prefill is the same path that built the KV the first
  time, so a preempted stream's final tokens are bit-identical to an
  unpreempted run.

Scheduling is host-side Python over numpy block tables, copied to the
device with each program call. Inactive slots decode a dummy token against an all--1 block
table row, which routes their KV writes to the reserved sink page (see
``models.common``). Outputs are greedy argmax — the engine serves
deterministic synthetic traffic for benchmarks and tests.

Faults are isolated per stream: a non-finite logit row fails only that
request (state ``failed``); everything else in the batch continues.
``drain()`` is the graceful way out — stop admission, finish (or
preempt-and-report) in-flight work, return per-request statuses.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..interop import tree_leaves
from ..kernels.kvattn.ops import BACKENDS
from ..launch.watchdog import StepWatchdog
from ..models.common import NO_QUANT, PAGED_KV_DTYPES
from .pages import PagePool, PagePoolExhausted

OVERCOMMIT_MODES = ("none", "prompt")


class RequestRejected(ValueError):
    """``submit()`` refused a request. ``reason`` is a stable slug that
    also lands in ``engine.events`` as a ``reject:<reason>`` entry."""

    def __init__(self, msg: str, *, reason: str, uid: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.uid = uid


class EngineStalledError(RuntimeError):
    """``run(max_ticks=)`` expired with requests still pending.

    Completed work is NOT thrown away: the error carries the engine
    ``metrics`` snapshot and the per-request ``states`` map so a caller
    can harvest every finished stream before deciding what to do.
    """

    def __init__(self, max_ticks, metrics: dict, states: dict):
        self.metrics = metrics
        self.states = states
        stuck = sorted(u for u, s in states.items() if s in ACTIVE_STATES)
        super().__init__(
            f"run() hit max_ticks={max_ticks} with requests still pending "
            f"(uids {stuck}); .metrics and .states carry the completed work")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 8
    page_size: int = 16
    num_pages: int = 257          # includes the reserved sink page 0
    max_len: int = 256            # hard cap on prompt + generated per stream
    prefill_chunk: int = 32
    kv_dtype: str = "int8"        # member of models.common.PAGED_KV_DTYPES
    backend: str = "auto"         # attend_int8_paged backend for the int8 decode read
    record_logits: bool = False   # keep per-step decode logits (tests only)
    overcommit: str = "none"      # 'none' (worst-case reserve) | 'prompt'
    overcommit_headroom: int = 1  # pages reserved beyond the prompt

    @property
    def max_pages_per_stream(self) -> int:
        return -(-self.max_len // self.page_size)

    @property
    def program_shape(self) -> tuple:
        """The fields the two device programs depend on. Scheduler
        policy (overcommit, headroom, record_logits) is host-side only —
        engines differing just there can share programs (see
        ``ServeEngine`` ``share_compiled``)."""
        return (self.num_slots, self.page_size, self.num_pages,
                self.max_len, self.prefill_chunk, self.kv_dtype,
                self.backend)

    def __post_init__(self):
        if self.kv_dtype not in PAGED_KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in {PAGED_KV_DTYPES}")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the sink)")
        if self.overcommit not in OVERCOMMIT_MODES:
            raise ValueError(
                f"overcommit {self.overcommit!r} not in {OVERCOMMIT_MODES}")
        if self.overcommit_headroom < 0:
            raise ValueError("overcommit_headroom must be >= 0")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")


# request lifecycle:
#   waiting -> prefill -> decode -> done
#                  |          |--> cancelled | expired | failed
#                  +----------+--> (preempted) -> waiting   [pages freed,
#                                  re-prefill of prompt+generated resumes
#                                  bit-exact]
@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new: int
    priority: int = 0                      # higher survives preemption longer
    deadline_tick: Optional[int] = None    # absolute tick; None = no deadline
    state: str = "waiting"
    slot: int = -1
    prefill_off: int = 0
    admit_seq: int = -1                    # admission order (newest = victim)
    preemptions: int = 0
    error: Optional[str] = None            # set when state == 'failed'
    generated: list = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)
    # tokens the current prefill pass feeds: the prompt, or — after a
    # preemption — prompt + generated[:-1], rebuilding the exact KV the
    # stream held so decode resumes by feeding generated[-1]
    prefill_src: Optional[np.ndarray] = None


RequestState = ("waiting", "prefill", "decode", "done", "cancelled",
                "expired", "failed")
ACTIVE_STATES = ("waiting", "prefill", "decode")
TERMINAL_STATES = ("done", "cancelled", "expired", "failed")


class ServeEngine:
    """Request-level serving over one model + weight set.

    ``quant`` is the artifact's :class:`QuantHook` (weights stay packed
    int codes through every linear); ``NO_QUANT`` serves FP weights. The
    engine serves on the device its params lie on and allocates the KV
    pool there.

    ``share_compiled`` is a test/bench convenience: another engine with
    the *same* model, quant hook and program shape
    (``EngineConfig.program_shape`` — scheduler policy may differ)
    whose two programs and warm-up are reused (the programs close over
    none of the per-engine state — params, cache and block tables are
    arguments).
    """

    def __init__(self, model, params, cfg: EngineConfig = EngineConfig(), *,
                 quant=NO_QUANT, share_compiled: "ServeEngine" = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.quant = quant
        self.device = tree_leaves(params)[0].device
        with torch.inference_mode():
            self.cache = model.init_paged_cache(cfg.num_pages, cfg.page_size,
                                                cfg.kv_dtype, self.device)
        self.pool = PagePool(cfg.num_pages)
        self.block_tables = np.full(
            (cfg.num_slots, cfg.max_pages_per_stream), -1, np.int32)
        self.slot_req: list[Optional[Request]] = [None] * cfg.num_slots
        self.waiting: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self.events: list[tuple[int, str, int]] = []
        self.tick = 0
        self.draining = False
        self._uid = 0
        self._pf_ptr = 0
        self._admit_seq = 0
        self._decode_ticks = 0
        self.decode_tick_log: list[int] = []  # tick ids that ran a decode step
        self._tokens_generated = 0
        self._occupancy: list[float] = []
        self._resident: list[float] = []
        self._peak_pages = 0
        self._wall_s = 0.0
        self._compile_s: Optional[float] = None
        self._preemptions = 0
        self._replay_chunks = 0   # prefill chunks spent rebuilding preempted KV
        self._expired = 0
        self._failed = 0
        self._cancelled = 0
        # per-tick stall detector; notes land in watchdog_notes, counts
        # in metrics()['stragglers']
        self.watchdog_notes: list[str] = []
        self._watchdog = StepWatchdog(log=self.watchdog_notes.append,
                                      label="tick")
        # whole-model KV bytes per page: every pool leaf is
        # (stack_n, num_pages, page_size, ...), so nbytes/num_pages sums
        # one page's footprint across all layers (scales included)
        self.bytes_per_page = sum(
            leaf.numel() * leaf.element_size() // cfg.num_pages
            for leaf in tree_leaves(self.cache))

        ps, backend = cfg.page_size, cfg.backend

        def extras(bt):
            return {"paged": {"block_tables": bt, "page_size": ps,
                              "backend": backend}}

        @torch.inference_mode()
        def decode_fn(params, tokens, cache, pos, bt):
            return model.decode_step(params, tokens, cache, pos, quant,
                                     extras=extras(bt))

        @torch.inference_mode()
        def chunk_fn(params, tokens, cache, pos, bt):
            return model.decode_step(params, tokens, cache, pos, quant,
                                     extras=extras(bt), all_logits=True)

        # compile() sets _decode_c/_chunk_c after the warm-up; step() calls
        # them, so a fault injector can wrap them
        self._decode_fn, self._chunk_fn = decode_fn, chunk_fn
        self._decode_c = self._chunk_c = None
        if share_compiled is not None:
            donor = share_compiled
            if donor.cfg.program_shape != cfg.program_shape:
                raise ValueError("share_compiled donor has a different "
                                 "program shape — compiled programs would "
                                 "not match")
            self._decode_fn, self._chunk_fn = donor._decode_fn, donor._chunk_fn
            self._decode_c = donor._decode_c
            self._chunk_c = donor._chunk_c
            self._compile_s = donor._compile_s

    @classmethod
    def from_artifact(cls, artifact_dir: str, *, arch: Optional[str] = None,
                      reduced: bool = False,
                      cfg: Optional[EngineConfig] = None,
                      device=None) -> "ServeEngine":
        """Build an engine from a saved artifact directory (written by
        either package), serving on ``device`` (default ``cuda``; raises
        without a GPU unless ``device="cpu"``).

        The load verifies schema + per-leaf checksums first, so a
        corrupted artifact raises ``ArtifactCorruptionError`` before any
        engine state exists — no slot is ever admitted against damaged
        weights. KV dtype / page size default from the manifest (written
        at export) when ``cfg`` is not given.
        """
        from ..deploy import QuantizedArtifact
        from ..device import resolve
        from ..models import get_model

        device = resolve(device)
        artifact = QuantizedArtifact.load(artifact_dir, verify=True)
        m = artifact.manifest
        if cfg is None:
            cfg = EngineConfig(kv_dtype=m.get("kv_dtype", "int8"),
                               page_size=int(m.get("kv_page_size", 16)))
        _, model = get_model(arch or m["arch"], reduced=reduced)
        artifact = artifact.to(device)
        return cls(model, artifact.params, cfg, quant=artifact.hook())

    # -- request surface ---------------------------------------------------

    def submit(self, prompt, max_new: int, uid: Optional[int] = None, *,
               priority: int = 0,
               deadline_ticks: Optional[int] = None) -> int:
        """Queue a request; returns its uid.

        ``priority``: preemption victims are picked lowest-priority
        first (ties: newest admission). ``deadline_ticks``: relative
        deadline — if the request has not finished within that many
        ticks of submission it moves to the terminal ``expired`` state
        and its pages are reclaimed.

        Raises :class:`RequestRejected` (a ``ValueError``) with a
        ``reason`` slug that is also logged to ``events``.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if uid is None:
            uid = self._uid

        def reject(reason: str, msg: str):
            self._log(f"reject:{reason}", uid)
            raise RequestRejected(msg, reason=reason, uid=uid)

        if self.draining:
            reject("draining", "engine is draining — admission is stopped")
        live = self.requests.get(uid)
        if live is not None and live.state in ACTIVE_STATES:
            reject("duplicate_uid",
                   f"uid {uid} is still live (state {live.state!r}) — "
                   f"resubmitting would orphan it in the scheduler")
        if max_new < 1:
            reject("bad_max_new", "max_new must be >= 1")
        if len(prompt) + max_new > self.cfg.max_len:
            reject("too_long",
                   f"prompt {len(prompt)} + max_new {max_new} exceeds "
                   f"max_len {self.cfg.max_len}")
        if self._pages_for(len(prompt) + max_new) > self.cfg.num_pages - 1:
            reject("exceeds_pool",
                   f"request needs {self._pages_for(len(prompt) + max_new)} "
                   f"pages at worst case but the pool only has "
                   f"{self.cfg.num_pages - 1} — it could never finish")
        if deadline_ticks is not None and deadline_ticks < 1:
            reject("bad_deadline", "deadline_ticks must be >= 1")
        self._uid = max(self._uid, uid) + 1
        req = Request(uid, prompt, max_new, priority=priority,
                      deadline_tick=(None if deadline_ticks is None
                                     else self.tick + int(deadline_ticks)))
        self.requests[uid] = req
        self.waiting.append(req)
        self._log("submit", uid)
        return uid

    def cancel(self, uid: int) -> bool:
        """Abort a request; its pages return to the pool immediately."""
        req = self.requests.get(uid)
        if req is None or req.state in TERMINAL_STATES:
            return False
        if req.state == "waiting":
            self.waiting.remove(req)
        else:
            self._release(req)
        req.state = "cancelled"
        self._cancelled += 1
        self._log("cancel", uid)
        return True

    def pending(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slot_req)

    # -- scheduler tick ----------------------------------------------------

    def step(self) -> bool:
        """One tick: expire, admit, one prefill chunk, one batched decode."""
        self._ensure_compiled()
        self._watchdog.start()
        t0 = time.perf_counter()
        self._expire_deadlines()
        self._admit()
        did = self._prefill_one()
        did = self._decode_all() or did
        self._peak_pages = max(self._peak_pages, self.pool.pages_in_use)
        self._wall_s += time.perf_counter() - t0
        self._watchdog.stop(self.tick)
        self.tick += 1
        return did or self.pending()

    def run(self, max_ticks: Optional[int] = None, *, strict: bool = True,
            shutdown=None) -> dict:
        """Tick until every submitted request finishes; returns metrics.

        ``max_ticks`` bounds the work. If it expires with requests still
        pending, ``strict=True`` raises :class:`EngineStalledError`
        carrying metrics + per-request states (completed work is never
        thrown away); ``strict=False`` returns the metrics dict with
        ``stalled=True`` and the ``states`` map instead.

        ``shutdown``: a ``launch.watchdog.GracefulShutdown`` — when its
        ``requested`` flag flips (SIGTERM/SIGINT), the engine drains
        gracefully and returns metrics with ``drained=True`` + the
        per-request ``states``.
        """
        limit = self.tick + max_ticks if max_ticks is not None else None
        while self.pending() and (limit is None or self.tick < limit):
            if shutdown is not None and shutdown.requested:
                states = self.drain(finish=True)
                m = self.metrics()
                m["drained"] = True
                m["states"] = states
                return m
            self.step()
        if self.pending():
            states = {u: r.state for u, r in self.requests.items()}
            if strict:
                raise EngineStalledError(max_ticks, self.metrics(), states)
            m = self.metrics()
            m["stalled"] = True
            m["states"] = states
            return m
        return self.metrics()

    def drain(self, *, finish: bool = True,
              max_ticks: Optional[int] = None) -> dict:
        """Graceful drain: stop admission, settle in-flight work, report.

        ``finish=True`` keeps ticking until every slotted request
        reaches a terminal state (bounded by each stream's ``max_new``,
        or by ``max_ticks``); ``finish=False`` preempts in-flight
        streams immediately. Either way no pages stay allocated — still-
        unfinished streams end ``waiting`` (pages freed, resumable) and
        ``assert_no_leaks()`` passes. Returns ``{uid: state}`` for every
        request the engine has seen. Idempotent.
        """
        self.draining = True
        self._log("drain", -1)
        if finish:
            limit = self.tick + max_ticks if max_ticks is not None else None
            while (any(r is not None for r in self.slot_req)
                   and (limit is None or self.tick < limit)):
                self.step()
        for req in list(self.slot_req):
            if req is not None:
                self._preempt(req)
        return {u: r.state for u, r in self.requests.items()}

    def compile(self) -> float:
        """Make both programs ready; returns their set-up seconds.

        On the card this loads the kernel libraries the programs launch
        (building them at first use): ``qgemv``/``qmatmul`` for packed
        weights, ``kv_decode`` for an int8 pool, unless the backends ask
        for the plain versions. Then it runs one warm-up decode and one
        warm-up chunk against a scratch pool (its sink page only), which
        leaves the engine's own pool, counters and block tables alone.
        Called lazily by step() — call it up front to keep set-up out of
        measured serving walls."""
        if self._compile_s is None:
            cfg = self.cfg
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                if cfg.kv_dtype == "int8" and cfg.backend != "torch":
                    from ..kernels.kvattn import kernel as kv_kernel

                    kv_kernel.load_library()
                if (self.quant.packed_backend != "torch"
                        and any(t.dtype == torch.int8
                                for t in tree_leaves(self.params))):
                    from ..kernels.qmatmul import kernel as qmm_kernel

                    qmm_kernel.load_library()
            with torch.inference_mode():
                scratch = self.model.init_paged_cache(
                    1, cfg.page_size, cfg.kv_dtype, self.device)
            bt = self._dev(np.full_like(self.block_tables, -1))
            tok = self._dev(np.zeros((cfg.num_slots, 1), np.int32))
            pos = self._dev(np.zeros((cfg.num_slots,), np.int32))
            self._decode_fn(self.params, tok, scratch, pos, bt)
            tokc = self._dev(np.zeros((1, cfg.prefill_chunk), np.int32))
            self._chunk_fn(self.params, tokc, scratch, pos[:1], bt[:1])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._decode_c, self._chunk_c = self._decode_fn, self._chunk_fn
            self._compile_s = time.perf_counter() - t0
        return self._compile_s

    # -- invariants / metrics ----------------------------------------------

    def assert_no_leaks(self) -> None:
        """Every page refcount back to zero and every block table clear."""
        self.pool.check_no_leaks()
        if (self.block_tables != -1).any():
            raise AssertionError("block table rows not cleared after release")

    def metrics(self) -> dict:
        toks = self._tokens_generated
        return {
            "ticks": self.tick,
            "decode_ticks": self._decode_ticks,
            "tokens_generated": toks,
            "wall_s": self._wall_s,
            "compile_s": self._compile_s or 0.0,
            "sustained_tok_s": toks / self._wall_s if self._wall_s else 0.0,
            "mean_slot_occupancy": (float(np.mean(self._occupancy))
                                    if self._occupancy else 0.0),
            "bytes_per_page": self.bytes_per_page,
            "peak_pages_in_use": self._peak_pages,
            "mean_resident_kv_bytes_per_stream": (
                float(np.mean(self._resident)) if self._resident else 0.0),
            "kv_dtype": self.cfg.kv_dtype,
            "page_size": self.cfg.page_size,
            "num_slots": self.cfg.num_slots,
            "overcommit": self.cfg.overcommit,
            "preemptions": self._preemptions,
            "replay_prefill_chunks": self._replay_chunks,
            "expired": self._expired,
            "failed": self._failed,
            "cancelled": self._cancelled,
            "stragglers": self._watchdog.stragglers,
            "mean_tick_s": self._watchdog.mean or 0.0,
            "draining": self.draining,
        }

    # -- internals ---------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the serving device."""
        return torch.from_numpy(a).to(self.device)

    def _log(self, event: str, uid: int) -> None:
        self.events.append((self.tick, event, uid))

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def _admission_need(self, req: Request) -> int:
        """Pages to reserve at admission under the overcommit policy."""
        worst = self._pages_for(len(req.prompt) + req.max_new)
        if self.cfg.overcommit == "none" or req.preemptions:
            # resumed streams reserve pessimistically: re-admitting a
            # victim optimistically just to evict it again burns replay
            # prefill chunks for nothing (admit/evict thrash), so a
            # stream comes back only once it is guaranteed to finish
            return worst
        # 'prompt': what prefill will write, plus a little headroom
        return min(self._pages_for(len(req.prompt))
                   + self.cfg.overcommit_headroom, worst)

    def _expire_deadlines(self) -> None:
        for req in [*self.waiting,
                    *(r for r in self.slot_req if r is not None)]:
            if (req.deadline_tick is not None
                    and self.tick >= req.deadline_tick):
                if req.state == "waiting":
                    self.waiting.remove(req)
                else:
                    self._release(req)
                req.state = "expired"
                self._expired += 1
                self._log("expired", req.uid)

    def _admit(self) -> None:
        if self.draining:
            return
        free = [s for s in range(self.cfg.num_slots) if self.slot_req[s] is None]
        while self.waiting and free:
            req = self.waiting[0]
            need = self._admission_need(req)
            if not self.pool.can_reserve(need):
                break  # head-of-line: preserve FIFO completion order
            self.waiting.popleft()
            self.pool.reserve(req.uid, need)
            req.slot = free.pop(0)
            self.slot_req[req.slot] = req
            req.state = "prefill"
            req.prefill_off = 0
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            # after a preemption the prefill replays prompt + all-but-the-
            # last generated token, rebuilding the stream's exact KV;
            # decode then resumes by feeding generated[-1]
            req.prefill_src = (
                req.prompt if not req.generated else
                np.concatenate([req.prompt,
                                np.asarray(req.generated[:-1], np.int32)]))
            self._log("admit" if req.preemptions == 0 else "readmit", req.uid)

    def _release(self, req: Request) -> None:
        self.pool.free_owner(req.uid)
        if req.slot >= 0:
            self.block_tables[req.slot, :] = -1
            self.slot_req[req.slot] = None
            req.slot = -1

    def _preempt(self, req: Request) -> None:
        """Evict a slotted stream: free its pages, re-queue it (front —
        it was admitted before anything still waiting) for a bit-exact
        re-prefill resume."""
        self._release(req)
        req.state = "waiting"
        req.prefill_off = 0
        req.preemptions += 1
        self._preemptions += 1
        self.waiting.appendleft(req)
        self._log("preempt", req.uid)

    def _preempt_for(self, req: Request) -> bool:
        """Pick and evict a victim so ``req`` can take a page. Lowest
        priority first, newest admission among equals; ``req`` itself is
        never a candidate. False when no victim exists."""
        cands = [r for r in self.slot_req if r is not None and r is not req]
        if not cands:
            return False
        victim = min(cands, key=lambda r: (r.priority, -r.admit_seq))
        self._preempt(victim)
        return True

    def _fail(self, req: Request, reason: str) -> None:
        """Per-stream fault isolation: only this request dies."""
        self._release(req)
        req.state = "failed"
        req.error = reason
        self._failed += 1
        self._log("failed", req.uid)

    def _ensure_pages(self, req: Request, last_pos: int) -> None:
        """Lazily allocate pages to cover positions [0, last_pos].

        Under overcommit the reservation grows just-in-time; when the
        pool has nothing left to promise, a victim stream is preempted
        until it does. A lone stream can always finish: submit() caps
        worst-case need at the pool size."""
        need = last_pos // self.cfg.page_size + 1
        while self.pool.refcount(req.uid) < need:
            if self.pool.reserved_for(req.uid) <= 0:
                while not self.pool.add_reservation(req.uid, 1):
                    if not self._preempt_for(req):
                        raise PagePoolExhausted(
                            f"request {req.uid} needs a page but the pool is "
                            f"exhausted and no victim remains")
            n = self.pool.refcount(req.uid)
            self.block_tables[req.slot, n] = self.pool.alloc(req.uid)

    def _ensure_compiled(self) -> None:
        if self._decode_c is None:
            self.compile()

    def _prefill_one(self) -> bool:
        ns = self.cfg.num_slots
        for i in range(ns):
            s = (self._pf_ptr + i) % ns
            req = self.slot_req[s]
            if req is not None and req.state == "prefill":
                self._pf_ptr = (s + 1) % ns
                self._prefill_chunk(req)
                return True
        return False

    def _prefill_chunk(self, req: Request) -> None:
        C = self.cfg.prefill_chunk
        src = req.prefill_src if req.prefill_src is not None else req.prompt
        off = req.prefill_off
        chunk = src[off:off + C]
        n_real = len(chunk)
        if n_real < C:  # ragged tail: pads write to the sink / dead rows
            chunk = np.pad(chunk, (0, C - n_real))
        self._ensure_pages(req, off + n_real - 1)
        s = req.slot
        logits, self.cache = self._chunk_c(
            self.params, self._dev(chunk[None].astype(np.int32)), self.cache,
            self._dev(np.full((1,), off, np.int32)),
            self._dev(self.block_tables[s:s + 1].copy()))
        req.prefill_off = off + n_real
        if req.preemptions:
            self._replay_chunks += 1
        self._log("prefill_chunk", req.uid)
        if req.prefill_off >= len(src):
            if req.generated:
                # resumed stream: KV rebuilt, tokens already pinned —
                # decode continues from generated[-1]
                req.state = "decode"
                self._log("resume", req.uid)
                return
            lg = logits[0, n_real - 1].cpu().numpy()
            if not np.isfinite(lg).all():
                self._fail(req, "non-finite logits at prefill")
                return
            req.generated.append(int(lg.argmax()))
            if self.cfg.record_logits:
                req.logits.append(lg)
            req.state = "decode"
            self._tokens_generated += 1
            self._log("first_token", req.uid)
            self._maybe_finish(req)

    def _decode_all(self) -> bool:
        cfg = self.cfg
        decoding = [s for s in range(cfg.num_slots)
                    if self.slot_req[s] is not None
                    and self.slot_req[s].state == "decode"]
        if not decoding:
            return False
        tokens = np.zeros((cfg.num_slots, 1), np.int32)
        pos = np.zeros((cfg.num_slots,), np.int32)
        # non-decoding slots get an all--1 block table row so their dummy
        # writes land on the sink page instead of a prefilling stream's KV
        bt = np.full_like(self.block_tables, -1)
        staged = []
        for s in decoding:
            req = self.slot_req[s]
            if req is None or req.state != "decode":
                continue  # preempted this tick by an earlier slot's page grab
            pos[s] = len(req.prompt) + len(req.generated) - 1
            tokens[s, 0] = req.generated[-1]
            self._ensure_pages(req, int(pos[s]))
            bt[s] = self.block_tables[s]
            staged.append(s)
        # a later slot's _ensure_pages may have preempted an earlier
        # staged one — its pages are gone, so route its write to the sink
        # and drop it from this tick's batch (it re-prefills on readmit)
        live = [s for s in staged if self.slot_req[s] is not None
                and self.slot_req[s].state == "decode"]
        for s in set(staged) - set(live):
            bt[s] = -1
        if not live:
            return False
        logits, self.cache = self._decode_c(
            self.params, self._dev(tokens), self.cache, self._dev(pos),
            self._dev(bt))
        lg = logits.cpu().numpy()
        n_ok = 0
        for s in live:
            req = self.slot_req[s]
            row = lg[s]
            if not np.isfinite(row).all():
                self._fail(req, "non-finite logits")
                continue
            req.generated.append(int(row.argmax()))
            if self.cfg.record_logits:
                req.logits.append(row)
            n_ok += 1
            self._maybe_finish(req)
        self._decode_ticks += 1
        self.decode_tick_log.append(self.tick)
        self._tokens_generated += n_ok
        self._occupancy.append(len(live) / cfg.num_slots)
        active = sum(r is not None for r in self.slot_req)
        if active:
            self._resident.append(
                self.pool.pages_in_use * self.bytes_per_page / active)
        return True

    def _maybe_finish(self, req: Request) -> None:
        if len(req.generated) >= req.max_new:
            self._release(req)
            req.state = "done"
            self._log("finish", req.uid)
