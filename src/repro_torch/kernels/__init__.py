"""Hand-written Hopper kernels of the port, built by ``build.py``.

  qmatmul/   packed int2/int4/int8 weight dequant-matmul: the decode GEMV
             (``qgemv``) and the prefill GEMM (``qmatmul``), CUDA C++
  kvattn/    int8-KV decode attention of the serve engine (``kv_decode``),
             CUDA C++
  fakequant/ the fused AdaRound forward (``fakequant``) of calibration's
             hardened forward and ``bake``, CUDA C++
"""
