"""Unit programs: ``readers.opt_iter_ms``."""
from perfbench.readers import opt_iter_ms as read  # noqa: F401
