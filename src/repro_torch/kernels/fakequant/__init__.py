"""Fused AdaRound forward (K5): CUDA kernel (kernel.py), plain PyTorch
version (ref.py) and the public wrapper (ops.py)."""
