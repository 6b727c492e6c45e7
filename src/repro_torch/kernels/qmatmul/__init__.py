"""Packed int2/int4/int8 weight dequant-matmul: CUDA kernels (kernel.py),
plain PyTorch versions (ref.py) and the shape-driven dispatcher (ops.py)."""
