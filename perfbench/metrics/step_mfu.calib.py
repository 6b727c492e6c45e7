"""Whole iteration's share of the peak: ``readers.step_mfu_calib``."""
from perfbench.readers import step_mfu_calib as read  # noqa: F401
