"""Hand-written Hopper kernels for the packed deployment path.

  qmatmul/   packed int2/int4/int8 weight dequant-matmul: the decode GEMV
             (``qgemv``) and the prefill GEMM (``qmatmul``), CUDA C++
"""
