"""Step-addressed checkpoints with atomic commit (npz + manifest).

Same on-disk layout as the JAX package's ``repro.ckpt``, so either
package reads what the other wrote:

  <dir>/step_000123/arrays.npz     flattened '/'-joined tree paths -> arrays
  <dir>/step_000123/manifest.json  {step, time, n_arrays, meta}

A checkpoint only counts once ``manifest.json`` exists: the save writes
into ``step_X.tmp`` and renames, so a preempted save is never mistaken
for a complete one.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..interop import flatten_paths

SEP = "/"


class CheckpointReadError(RuntimeError):
    """A checkpoint's array payload could not be read (truncated file,
    corrupt zip, missing member). Carries the path that failed, and the
    flat tree path of the member when the zip layer named one."""

    def __init__(self, path, cause: Exception, member: Optional[str] = None):
        super().__init__(f"cannot read checkpoint arrays at {path}: "
                         f"{type(cause).__name__}: {cause}")
        self.path = str(path)
        self.cause = cause
        self.member = member.removesuffix(".npy") if member else None


def _load_npz(path: Path):
    """np.load with truncation/corruption mapped to CheckpointReadError."""
    try:
        return np.load(path)
    except Exception as e:  # BadZipFile, EOFError, OSError, ValueError...
        raise CheckpointReadError(path, e) from e


def _read_member_lax(z, name: str) -> np.ndarray:
    """Re-read one npz member with the zip CRC check disabled (the
    non-strict path for payloads known or accepted to be damaged)."""
    f = z.zip.open(name)
    f._expected_crc = None  # CPython zipfile: None disables the CRC check
    return np.lib.format.read_array(io.BytesIO(f.read()), allow_pickle=False)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        flat = {k: _to_numpy(v) for k, v in flatten_paths(tree, SEP).items()}
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "time": time.time(), "n_arrays": len(flat),
             "meta": meta or {}}))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_nested(self, step: int, strict: bool = True) -> dict:
        """Rebuild nested dicts of CPU tensors from the flat '/'-joined
        keys. Dtypes (incl. int8 packed codes) round-trip exactly.

        ``strict=False`` retries a member that fails the zip layer's own
        CRC with the check disabled; a torn zip is still unreadable."""
        d = self.dir / f"step_{step:08d}"
        tree: dict = {}
        with _load_npz(d / "arrays.npz") as z:
            for key in z.files:
                node = tree
                parts = key.split(SEP)
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                try:
                    arr = z[key]
                except Exception as e:  # member truncated/corrupt mid-array
                    if strict:
                        raise CheckpointReadError(d / "arrays.npz", e,
                                                  member=key) from e
                    arr = _read_member_lax(z, key + ".npy")
                node[parts[-1]] = torch.from_numpy(np.array(arr, copy=True))
        return tree

    def manifest(self, step: int) -> dict:
        return json.loads((self.dir / f"step_{step:08d}" / "manifest.json").read_text())
