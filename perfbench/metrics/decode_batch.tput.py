"""Slots a decode tick: ``readers.decode_batch``."""
from perfbench.readers import decode_batch as read  # noqa: F401
