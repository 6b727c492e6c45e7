"""Resumable-calibration journal: per-unit progress on disk.

The port of the JAX package's ``repro.core.journal``. ``quantize(workdir=
...)`` writes one snapshot after every reconstructed unit through
:class:`repro_torch.ckpt.CheckpointManager` (atomic temp-dir + rename,
``keep=1``), holding exactly the state a restart cannot recompute:

  * the activation streams (``x_fp`` / ``x_q`` and, past an enc->dec
    boundary, ``mem_fp`` / ``mem_q``);
  * the accumulated rounding logits ``v`` and LSQ act scales ``s``;
  * per-unit stats (JSON) and the next unit index.

Everything else — quantizer states, the 8-bit embed/head handling, the
Fisher stream, the per-unit minibatch generators (seeded from
``(rc.seed, unit)``) — is a pure function of (params, calib set,
ReconConfig) and is recomputed on resume, which is what makes a resumed
run bit-identical to an uninterrupted one on the same device.

numpy has no bfloat16: bf16 streams are stored as their int16 bit
patterns and listed in the snapshot's meta (``bf16``), so they come back
bit for bit. Loaded tensors lie on the CPU; the caller moves them.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager, CheckpointReadError

_ESC = "%2F"  # calibration paths contain '/', the ckpt tree separator


class CalibJournalError(RuntimeError):
    """The journal in ``workdir`` cannot be used by this run (written by
    a different config/model/calib set, or unreadable)."""


class CalibrationInterrupted(RuntimeError):
    """Calibration checkpointed at a unit boundary and stopped on
    SIGTERM/SIGINT. The journal in ``workdir`` is complete through
    ``next_unit - 1``; re-run ``quantize`` with the same ``workdir`` to
    continue."""

    def __init__(self, workdir: str, next_unit: int, n_units: int):
        super().__init__(
            f"calibration interrupted by signal after unit {next_unit - 1}; "
            f"journal at {workdir} holds {next_unit}/{n_units} units — "
            f"re-run quantize(workdir=...) to resume")
        self.workdir = str(workdir)
        self.next_unit = next_unit
        self.n_units = n_units


def _jsonable(obj: Any) -> Any:
    """Stats trees carry numpy arrays/scalars; manifest meta is JSON."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class CalibJournal:
    """Per-unit calibration progress in ``workdir`` (see module doc)."""

    def __init__(self, workdir: str, signature: dict):
        self.workdir = str(workdir)
        self.signature = _jsonable(signature)
        self._mgr = CheckpointManager(workdir, keep=1)

    # -- write ----------------------------------------------------------------

    def save(self, next_unit: int, x_fp: torch.Tensor, x_q: torch.Tensor,
             mem_fp: Optional[torch.Tensor], mem_q: Optional[torch.Tensor],
             v_all: dict, s_all: dict, unit_stats: list,
             stream_peak: int) -> None:
        tree = {"x_fp": x_fp, "x_q": x_q,
                "v": {k.replace("/", _ESC): v for k, v in v_all.items()},
                "s": {k.replace("/", _ESC): v for k, v in s_all.items()}}
        if mem_fp is not None:
            tree["mem_fp"] = mem_fp
        if mem_q is not None:
            tree["mem_q"] = mem_q
        bf16 = sorted(k for k, t in tree.items()
                      if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16)
        for k in bf16:
            tree[k] = tree[k].view(torch.int16)
        self._mgr.save(next_unit, tree, meta={
            "signature": self.signature, "next_unit": next_unit,
            "units": _jsonable(unit_stats), "stream_peak": int(stream_peak),
            "bf16": bf16})

    # -- read -----------------------------------------------------------------

    def load(self) -> Optional[dict]:
        """Latest snapshot as a dict, or None when the journal is empty.

        Raises :class:`CalibJournalError` when the snapshot was written
        by an incompatible run or cannot be read back."""
        step = self._mgr.latest_step()
        if step is None:
            return None
        meta = self._mgr.manifest(step)["meta"]
        sig = meta.get("signature")
        if sig != self.signature:
            diff = [k for k in set(self.signature) | set(sig or {})
                    if (sig or {}).get(k) != self.signature.get(k)]
            raise CalibJournalError(
                f"journal at {self.workdir} was written by a different "
                f"calibration run (mismatched: {sorted(diff)}); point "
                f"workdir at a fresh directory or delete the stale journal")
        try:
            tree = self._mgr.restore_nested(step)
        except CheckpointReadError as e:
            raise CalibJournalError(
                f"journal at {self.workdir} is unreadable (truncated or "
                f"corrupt snapshot): {e}") from e
        for k in meta.get("bf16", []):
            tree[k] = tree[k].view(torch.bfloat16)
        return {
            "next_unit": int(meta["next_unit"]),
            "x_fp": tree["x_fp"], "x_q": tree["x_q"],
            "mem_fp": tree.get("mem_fp"), "mem_q": tree.get("mem_q"),
            "v_all": {k.replace(_ESC, "/"): v
                      for k, v in tree.get("v", {}).items()},
            "s_all": {k.replace(_ESC, "/"): v
                      for k, v in tree.get("s", {}).items()},
            "unit_stats": list(meta.get("units", [])),
            "stream_peak": int(meta.get("stream_peak", 0)),
        }
