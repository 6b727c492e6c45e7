"""In-memory spans of the serve engine, on ``time.perf_counter_ns()``.

A span is ``(name, t0_ns, t1_ns, uid, parent)``: ``uid`` is the request's
id (-1 for a tick's spans) and ``parent`` the index in the list of the span
that caused it (-1 for none). Two kinds:

* **tick spans**: ``tick`` covers all of ``ServeEngine.step()``; its
  children (``tick.schedule``, ``chunk.stage|launch|readback``,
  ``decode.stage|launch|readback|sample``) lie inside it, in order, and
  name it as their parent. The tick's entry is reserved when it opens, so
  its children can point at it, and filled in when it closes.
* **request spans**: ``queued`` (submission or preemption to admission),
  ``prefill`` (admission to the first token, or to the resume after a
  replay; parent: the ``queued`` span) and ``decode`` (first token to the
  terminal state; parent: the ``prefill`` span). They follow one another;
  each is appended when it closes.

Off by default. The engine tests ``on`` at every span site and reads the
clock only when it is set, so a site costs one attribute test when off.
Nothing is written anywhere: :meth:`Trace.snapshot` hands the spans out.
``perf_counter_ns`` is the clock ``perfbench/trace.py`` aligns the
profiler's timeline to, so a span maps onto the device's by one offset.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

now = time.perf_counter_ns


class Trace:
    """The span list of one engine. ``counters``: the engine's integer
    counters, handed out beside the spans by :meth:`snapshot`."""

    def __init__(self, counters: Callable[[], dict]):
        self.on = False
        self.spans: list[tuple] = []  # (name, t0_ns, t1_ns, uid, parent)
        self._tick = -1  # index of the open tick's span
        self._open: dict[int, tuple] = {}  # uid -> (name, t0, parent)
        self._counters = counters

    def enable(self) -> None:
        """Start a new recording: earlier spans are dropped."""
        self.spans, self._open, self._tick = [], {}, -1
        self.on = True

    def disable(self) -> None:
        """Stop recording; what was recorded stays for :meth:`snapshot`."""
        self.on = False

    def snapshot(self) -> dict:
        """The closed spans, each request's open span cut at this moment
        (a stream still decoding has reached its first token), and the
        engine's counters."""
        t = now()
        cut = [(name, t0, t, uid, parent)
               for uid, (name, t0, parent) in self._open.items()]
        return {"spans": self.spans + cut, "counters": self._counters()}

    # -- tick spans ----------------------------------------------------------

    def open_tick(self, t0: int) -> None:
        self._tick = len(self.spans)
        self.spans.append(("tick", t0, -1, -1, -1))

    def close_tick(self, t1: int) -> None:
        self.spans[self._tick] = ("tick", self.spans[self._tick][1], t1, -1, -1)

    def child(self, name: str, t0: int, uid: int = -1) -> int:
        """Close a child of the open tick that began at ``t0``; returns its
        end, where the next child begins."""
        t1 = now()
        self.spans.append((name, t0, t1, uid, self._tick))
        return t1

    # -- request spans -------------------------------------------------------

    def phase(self, uid: int, nxt: Optional[str]) -> None:
        """Close ``uid``'s open span, if any, and open ``nxt`` (None: the
        request ended), caused by the closed one unless it is ``queued``."""
        t = now()
        i = -1
        if uid in self._open:
            name, t0, parent = self._open.pop(uid)
            i = len(self.spans)
            self.spans.append((name, t0, t, uid, parent))
        if nxt is not None:
            self._open[uid] = (nxt, t, -1 if nxt == "queued" else i)
