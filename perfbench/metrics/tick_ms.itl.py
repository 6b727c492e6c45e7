"""Scheduler tick: ``readers.tick_ms``."""
from perfbench.readers import tick_ms as read  # noqa: F401
