"""A traced part of the window: the device's timeline from ``torch.profiler``
and what the host was doing, sampled from the driver's thread.

``Window.start`` / ``stop`` bracket the traced part. The profiler records
the CUDA activity of the whole process (CUPTI); it is started and stopped
on a thread of its own, so the CPU ops of the thread that drives the work
are not recorded (they are not needed, and would cost that thread time).
A sampler thread reads the driving thread's Python stack every
``SAMPLE_S`` seconds; an idle gap of the device is named by the program
function the host was most often in during the gap.

Reduced here: ``busy_s`` (the union of every device activity), the traced
``window_s`` (host clock), the device time of the kernels of a family
(``work/kernels.py``'s frozen names), the ten device operations that took
most time and the ten longest idle gaps. :class:`CallBounds` adds up the
bound of a family's calls in the traced part from the dims each call
passes.
"""
from __future__ import annotations

import bisect
import collections
import queue
import re
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from perfbench.work import kernels, peaks

SAMPLE_S = 0.002


class CallBounds:
    """The summed bound of every call of one kernel family made while
    ``active``. The program's wrappers hand ``kernels/record.py::call`` their
    work function and the call's dims; while installed, this stands in for
    ``call``, reckons the call's operations and bytes from those dims with
    the benchmark's frozen formula, and hands the call on unchanged."""

    def __init__(self, family: str):
        self.family, self.active = family, False
        self.bound_s, self.calls = 0.0, 0

    def install(self):
        from repro_torch.kernels import record

        self._record, self._orig = record, record.call

        def call(work, *dims):
            if self.active:
                got = kernels.call_work(self.family, work.__name__, dims)
                if got is not None:
                    self.bound_s += peaks.bound_s(*got)
                    self.calls += 1
            return self._orig(work, *dims)

        record.call = call
        return self

    def remove(self):
        self._record.call = self._orig


def short(name: str, n: int = 96) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= n else name[:n - 3] + "..."


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _where(frame) -> str:
    """The innermost frame of the program (``repro_torch``) on the stack,
    else the innermost of the benchmark, as ``module.function``."""
    bench = None
    while frame is not None:
        fn = frame.f_code.co_filename
        if "repro_torch" in fn:
            mod = fn.rsplit("repro_torch", 1)[1].strip("/").removesuffix(".py").replace("/", ".")
            return f"{mod}.{frame.f_code.co_name}"
        if bench is None and "perfbench" in fn:
            bench = f"perfbench.{Path(fn).stem}.{frame.f_code.co_name}"
        frame = frame.f_back
    return bench or "other"


class Window:
    """One traced part of a run. ``thread_id``: the thread whose stack the
    sampler reads (the driving thread)."""

    def __init__(self, thread_id: Optional[int] = None):
        self.thread_id = thread_id or threading.get_ident()
        self.prof = None
        self.samples: list[tuple[int, str]] = []
        self._stop_sampling = threading.Event()
        self._sampler = None
        self.t0 = self.t1 = 0.0
        self.offset_ns = 0  # profiler clock minus perf_counter_ns
        self.device_events: list[tuple[str, int, int]] = []

    def _sample(self):
        frames = sys._current_frames
        while not self._stop_sampling.wait(SAMPLE_S):
            f = frames().get(self.thread_id)
            if f is not None:
                self.samples.append((time.perf_counter_ns(), _where(f)))

    def _on_profiler_thread(self, fn):
        """Run ``fn`` on the profiler's own thread (the same one for start
        and stop) and wait for it."""
        done, err = threading.Event(), []

        def call():
            try:
                fn()
            except BaseException as e:  # handed back to the caller
                err.append(e)
            done.set()

        self._jobs.put(call)
        done.wait()
        if err:
            raise err[0]

    def _serve_jobs(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job()

    def start(self):
        import warnings

        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._jobs = queue.Queue()
        self._worker = threading.Thread(target=self._serve_jobs, daemon=True)
        self._worker.start()

        def begin():
            warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            with record_function("perfbench::mark"):
                self._mark_ns = time.perf_counter_ns()

        self._on_profiler_thread(begin)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._stop_sampling.set()
        self._sampler.join()
        self._on_profiler_thread(lambda: self.prof.__exit__(None, None, None))
        self._jobs.put(None)
        self._worker.join()
        self._reduce()
        self.prof = None

    def _reduce(self):
        from torch.autograd import DeviceType

        evs = self.prof.profiler.kineto_results.events()
        mark = None
        dev = []
        for e in evs:
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
            elif mark is None and e.name() == "perfbench::mark":
                mark = e.start_ns()
        self.device_events = dev
        if mark is not None:
            self.offset_ns = mark - self._mark_ns

    # -- readings -----------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _busy(self) -> list[tuple[int, int]]:
        return merge([(a, b) for _n, a, b in self.device_events if b > a])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-9

    def family_time_s(self, family: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels of one family."""
        names = kernels.FAMILIES[family][3]
        t, n = 0, 0
        for name, a, b in self.device_events:
            if any(k in name for k in names):
                t += b - a
                n += 1
        return t * 1e-9, n

    def top_ops(self, k: int = 10) -> list[list]:
        acc: dict[str, int] = collections.defaultdict(int)
        for name, a, b in self.device_events:
            acc[short(name)] += b - a
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v * 1e-9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        busy = self._busy()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        samples = [(t + self.offset_ns, w) for t, w in self.samples]
        times = [t for t, _ in samples]
        out = []
        for a, b in gaps[:k]:
            lo, hi = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
            seen = collections.Counter(w for _, w in samples[lo:hi])
            if not seen:  # a gap shorter than the sampling interval: the last sample before it
                seen = collections.Counter([samples[lo - 1][1]] if lo else ["unsampled"])
            out.append([seen.most_common(1)[0][0], (b - a) * 1e-9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}
