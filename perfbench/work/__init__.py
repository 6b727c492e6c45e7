"""Frozen arithmetic of the benchmark: the H100's peaks, the model FLOPs of a
step, and the operations and bytes of each kernel call. Copied from the
program and held equal to it by ``tests/test_perfbench_work.py``."""
