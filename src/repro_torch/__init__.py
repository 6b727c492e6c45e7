"""PyTorch/CUDA port of the BRECQ serving stack.

Module paths mirror the JAX reference package ``repro``; this package
imports ``torch``, ``numpy`` and the standard library only. The packed
matmul kernels (``kernels/qmatmul``) and the serve engine's int8-KV
decode attention (``kernels/kvattn``) are hand-written CUDA for Hopper.
"""
