"""The paper's tables on the PyTorch/CUDA port (``repro_torch``): the
counterpart of ``benchmarks/``, one module per table, run through
``python -m benchmarks_torch.run``."""
