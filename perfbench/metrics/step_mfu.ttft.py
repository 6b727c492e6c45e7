"""Whole tick's share of the peak: ``readers.step_mfu_serve``."""
from perfbench.readers import step_mfu_serve as read  # noqa: F401
