"""Step-addressed checkpoints with atomic commit (npz + manifest).

Same on-disk layout as the JAX package's ``repro.ckpt``, so either
package reads what the other wrote:

  <dir>/step_000123/arrays.npz     flattened '/'-joined tree paths -> arrays
  <dir>/step_000123/manifest.json  {step, time, n_arrays, meta}

A checkpoint only counts once ``manifest.json`` exists: the save writes
into ``step_X.tmp`` and renames, so a preempted save is never mistaken
for a complete one.

Async: ``save_async`` copies every leaf to host numpy on the caller's
thread, then hands the copy to a writer thread, so an in-place update
after the call cannot tear the snapshot; ``wait`` joins the writer before
the next save or exit. ``restore(step, like)`` puts each leaf back on its
``like`` leaf's device with its dtype.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
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


def _flatten(tree) -> dict[str, np.ndarray]:
    """'/'-joined paths -> host copies (a CPU tensor's ``numpy()`` shares
    its memory, so it is copied)."""
    return {k: np.array(_to_numpy(v), copy=True)
            for k, v in flatten_paths(tree, SEP).items()}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self._write(step, _flatten(tree), meta or {})

    def save_async(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        flat = _flatten(tree)  # on the caller's thread: a consistent view
        self._thread = threading.Thread(
            target=self._write_catching, args=(step, flat, meta or {}), daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_catching(self, step: int, flat: dict, meta: dict):
        try:
            self._write(step, flat, meta)
        except Exception as e:  # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, flat: dict, meta: dict):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "time": time.time(), "n_arrays": len(flat),
             "meta": meta}))
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

    def restore(self, step: int, like: Any) -> Any:
        """``like``'s nested dicts with every leaf read from the checkpoint
        at its '/'-joined path, on that leaf's device with its dtype. A leaf
        whose shape differs from ``like``'s raises (a checkpoint of another
        configuration)."""
        flat = flatten_paths(self.restore_nested(step), SEP)

        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
            path = SEP.join(prefix)
            leaf = flat[path]
            if leaf.shape != node.shape:
                raise ValueError(f"checkpoint step {step} at {self.dir}: {path} has shape "
                                 f"{tuple(leaf.shape)}, expected {tuple(node.shape)}")
            return leaf.to(device=node.device, dtype=node.dtype)

        return walk(like, ())

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
