"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. There is
no silent fallback: asking for (or defaulting to) ``cuda`` on a machine
without a usable CUDA device raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when CUDA is asked
    for and not available; pass ``device="cpu"`` to run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the host")
    return dev
