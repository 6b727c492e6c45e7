"""Calibration entry: ``readers.unit_overhead``."""
from perfbench.readers import unit_overhead as read  # noqa: F401
