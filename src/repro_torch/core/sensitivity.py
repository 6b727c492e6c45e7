"""Layer sensitivities for mixed precision (paper Sec. 3.4).

The port of the JAX package's ``repro.core.sensitivity``. After the three
unified-precision calibrations (2/4/8-bit), measure per layer the
Fisher-weighted block-output error when ONLY that layer is quantized
(diagonal term), and — at 2-bit — the pairwise interaction inside each
block (off-diagonal term):

    offdiag(l1, l2) = joint(l1, l2) - diag(l1) - diag(l2).

Everything is stored in a lookup table; the genetic search and the exact
budget solver then never touch the network again. Each probe is an eager
forward of one block; its hardened weights go through
``adaround.hard_quant``, so on the card every probe runs K5
(``kernels/fakequant``). The table's JSON is the JAX package's, so a table
written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import itertools
import json

import torch

from ..interop import tree_leaves
from ..models.common import NO_QUANT, QuantHook
from . import adaround
from .fisher import FisherStream
from .quantizer import quantize_dequant
from .reconstruction import (PTQResult, Walker, _apply_unit, _concat_batches,
                             _slice_batch, enumerate_weights)


@dataclasses.dataclass
class SensTable:
    diag: dict[tuple[str, int], float]  # (path, bits) -> loss
    offdiag: dict[tuple[str, str], float]  # (p1, p2) both 2-bit -> interaction
    block_of: dict[str, int]  # path -> block index
    shapes: dict[str, tuple]  # path -> weight shape

    def to_json(self) -> dict:
        return {"diag": [[p, b, v] for (p, b), v in sorted(self.diag.items())],
                "offdiag": [[p1, p2, v] for (p1, p2), v
                            in sorted(self.offdiag.items())],
                "block_of": dict(self.block_of),
                "shapes": {p: list(s) for p, s in self.shapes.items()}}

    @classmethod
    def from_json(cls, doc: dict) -> "SensTable":
        return cls(
            diag={(p, int(b)): float(v) for p, b, v in doc["diag"]},
            offdiag={(p1, p2): float(v) for p1, p2, v in doc["offdiag"]},
            block_of={p: int(b) for p, b in doc["block_of"].items()},
            shapes={p: tuple(s) for p, s in doc["shapes"].items()})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "SensTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


class _SelectHook(QuantHook):
    """Hard-quantize only the selected paths, using calibrated rounding."""

    def __init__(self, results: dict[int, PTQResult], select: dict[str, int]):
        self.results = results
        self.select = select

    def weight(self, path, w):
        bits = self.select.get(path)
        if bits is None:
            return w
        res = self.results[bits]
        if path in res.v:
            st, cfg = res.qstates[path]
            return adaround.hard_quant(w, res.v[path], st, cfg)
        if path in res.qstates:
            st, cfg = res.qstates[path]
            return quantize_dequant(w, st, cfg)
        return w


@torch.no_grad()
def measure(model, params, calib_batches, results: dict[int, PTQResult],
            bits_options=(2, 4, 8), n_samples: int = 32,
            use_fisher: bool = True, pair_bits: int = 2) -> SensTable:
    """Build the sensitivity lookup table on the first ``n_samples``
    calibration sequences, where ``params`` live."""
    walker = Walker(model)
    device = tree_leaves(params)[0].device
    calib = _concat_batches([{k: v.to(device) for k, v in b.items()}
                             for b in calib_batches])
    n = min(n_samples, calib["tokens"].shape[0])
    sub = _slice_batch(calib, slice(0, n))

    # Fisher at block outputs on the subset: 'full' (f32, one backward)
    nb = len(walker.blocks())
    fisher = (FisherStream(walker, params, [sub], mode="full")
              if use_fisher else None)

    # paths per block (from any result's qstates, grouped by prefix)
    any_res = results[min(results)]
    block_paths: dict[int, list[str]] = {i: [] for i in range(nb)}
    block_of: dict[str, int] = {}
    for bi in range(nb):
        prefix = walker.block_path(bi) + "/"
        for p in any_res.qstates:
            if p.startswith(prefix):
                block_paths[bi].append(p)
                block_of[p] = bi

    weights = enumerate_weights(model, params, _slice_batch(calib, slice(0, 1)))
    shapes = {p: tuple(weights[p].shape) for p in block_of}

    diag: dict[tuple[str, int], float] = {}
    offdiag: dict[tuple[str, str], float] = {}

    # FP stream through blocks on the subset
    x_fp = walker.stem(params, sub)[0]
    mem_fp = None

    for bi in range(nb):
        z_fp = _apply_unit(walker, params, [bi], NO_QUANT, x_fp, sub, mem_fp)
        g2 = fisher.for_block(bi) if fisher is not None else None

        def err_fn(select: dict[str, int]) -> float:
            hook = _SelectHook(results, select)
            z = _apply_unit(walker, params, [bi], hook, x_fp, sub, mem_fp)
            err = (z - z_fp).to(torch.float32) ** 2
            if g2 is not None:
                err = err * g2
            return float(torch.mean(err))

        for p in block_paths[bi]:
            for b in bits_options:
                if b in results:
                    diag[(p, b)] = err_fn({p: b})
        for p1, p2 in itertools.combinations(block_paths[bi], 2):
            joint = err_fn({p1: pair_bits, p2: pair_bits})
            offdiag[(p1, p2)] = joint - diag[(p1, pair_bits)] - diag[(p2, pair_bits)]

        x_fp = z_fp
        if walker.encdec and bi == walker.enc_n - 1:
            mem_fp, x_fp = walker.boundary_transition(params, sub, x_fp)

    return SensTable(diag=diag, offdiag=offdiag, block_of=block_of, shapes=shapes)
