"""Step-time watchdog: straggler detection + preemption-safe shutdown.

A copy of the JAX package's ``repro.launch.watchdog`` (pure Python): (a)
notice abnormal step latency (EWMA z-score) and surface it, (b) stop
promptly on SIGTERM/SIGINT. The serve engine uses :class:`StepWatchdog`
for its per-tick straggler count, and ``launch/serve.py
--drain-on-sigterm`` uses :class:`GracefulShutdown`.
"""
from __future__ import annotations

import math
import signal
import time
from typing import Callable, Optional


class StepWatchdog:
    def __init__(self, z_threshold: float = 4.0, alpha: float = 0.05,
                 warmup: int = 5, log: Callable[[str], None] = print,
                 label: str = "step"):
        self.z = z_threshold
        self.alpha = alpha
        self.warmup = warmup
        self.log = log
        self.label = label
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.stragglers = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self.n += 1
        if self.mean is None:
            self.mean = dt
        else:
            if self.n > self.warmup:
                sd = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
                if dt > self.mean + self.z * sd:
                    self.stragglers += 1
                    self.log(f"[watchdog] {self.label} {step}: {dt:.2f}s "
                             f"(mean {self.mean:.2f}s +{self.z} sigma) — straggler")
            delta = dt - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return dt


class GracefulShutdown:
    """SIGTERM/SIGINT -> finish the current step, then stop.

    Consumed by ``launch/serve.py --drain-on-sigterm`` (the engine
    drains between ticks). Library callers that install the handlers
    temporarily must call :meth:`restore` (or use the instance as a
    context manager) so the process's previous SIGINT/SIGTERM behaviour
    comes back after the guarded section."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev: dict[int, object] = {}
        if install:
            self.install()

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()
        return False

    def _handler(self, signum, frame):
        self.requested = True
