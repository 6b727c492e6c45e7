"""Build and load the port's CUDA libraries.

Every kernel library is one ``.cu`` source with a plain C interface,
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the
repository root (listed in .gitignore) at first use, keyed by a hash of
its sources and flags, and loaded with ``ctypes``. Nothing is built when a
module is imported. Two libraries may build at once (from two threads):
each compiles into its own temporary file and renames it into place.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/kernels`` at the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME, PATH, default prefix

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return str(nvcc)


def build_library(name: str, sources, flags=NVCC_FLAGS) -> tuple[ctypes.CDLL, dict]:
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless that file
    exists, and load it. Returns the library and its build info: path,
    whether it was compiled in this call, seconds, and the compiler's
    register/spill report (``ptxas``, empty when it was loaded)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    built, log = False, ""
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(
            f"{lib_path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {res.returncode}: "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
        built, log = True, res.stderr
    info = {"path": str(lib_path), "built": built,
            "seconds": time.perf_counter() - t0, "ptxas": log}
    return ctypes.CDLL(str(lib_path)), info


def on_device(dev: torch.device):
    """Make ``dev`` current for a launch, unless it already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
