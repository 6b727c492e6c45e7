"""Serve a quantized model with batched requests, on the port.

    PYTHONPATH=src python examples/torch_serve_quantized.py [--device cpu]

The PyTorch counterpart of ``examples/serve_quantized.py``, a thin wrapper
over ``repro_torch.launch.serve``: packs the weights into a
``QuantizedArtifact`` (int4/int8 codes + scales), prefills a batch of
prompts and decodes greedily from the packed codes, on the card through
the ``qmatmul`` kernels (``qgemv`` at decode). With no arguments it takes
the JAX example's (reduced brecq-lm-100m, W4, batch 8, prompts of 64, 32
new tokens) on the GPU; arguments replace them, as in the JAX example. Pass
``--artifact DIR`` instead of ``--quant`` to serve a calibrated BRECQ
export, ``--engine`` for the continuous-batching engine.
"""
import sys

from repro_torch.launch import serve

DEFAULT_ARGV = ["--arch", "brecq_lm_100m", "--reduced", "--quant", "4", "--batch", "8",
                "--prompt-len", "64", "--gen-len", "32"]

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not argv or argv[:1] == ["--device"] and len(argv) == 2:
        argv = DEFAULT_ARGV + argv  # the JAX example's defaults, on any device
    serve.main(argv)
