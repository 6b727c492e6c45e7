"""Leaf-level packed-int weight format + the calibration-free RTN path.

The same format as the JAX package's ``repro.deploy.pack``: integer codes
packed into int8 containers along the reduction axis (``pack_int``
layout, offset-binary) plus per-(group, out-channel) f32 scales. A packed
linear node in a params tree is

    {"w": int8 (..., K * bits / 8, N), "qscale": f32 (..., G, N), ...}

where ``G = K / group_size`` (``G == 1`` for per-channel scales). Bits
and group are inferred from shapes at the use site (``K`` is known from
the activation), so the node carries no static metadata.

Container promotion: codes quantized at ``b`` bits may be stored in a
wider container (2-bit codes in a 4-bit field, or unpacked int8) without
changing their dequantized values; a reduction dim not divisible by the
packing factor falls back to an int8 container.

Integrity hashes (:func:`leaf_crc32`) are taken over the numpy view of
each leaf, so checksums and digests equal the JAX package's.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..core.quantizer import pack_int, unpack_int
from ..interop import flatten_paths, tree_leaves

Params = Any

# param-tree keys that stay FP even though they hold a linear weight
SKIP_KEYS = ("router",)
# leaves under these top-level keys quantize at 8 bits regardless of the
# requested width (first/last layers stay 8-bit, as in the paper)
EIGHT_BIT_ROOTS = ("embed", "head")


def container_bits(bits: int, k: int) -> int:
    """Container width for ``bits``-wide codes over a K-row reduction dim:
    2/4-bit codes pack when ``K`` divides by the values-per-byte factor;
    everything else stays in an int8 container (values unchanged)."""
    if bits >= 8 or 8 % bits != 0:
        return 8
    return bits if k % (8 // bits) == 0 else 8


def pack_codes(codes: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """(…, K, N) int8 codes -> packed (…, K*cbits/8, N) container."""
    return pack_int(codes, container_bits(bits, k), axis=-2)


def code_layout(wp: torch.Tensor, k: int) -> tuple[int, int]:
    """(container bits, values-per-byte) of a packed codes leaf whose
    reduction dim is ``k``. Raises ``ValueError`` when the row count
    cannot be a packed view of ``k``."""
    rows = wp.shape[-2]
    if rows == 0 or k % rows:
        raise ValueError(
            f"{rows} packed rows do not divide the reduction dim K={k} "
            f"(codes shape {tuple(wp.shape)})")
    per = k // rows
    if per not in (1, 2, 4):
        raise ValueError(
            f"{per} values/byte is not a packable container width "
            f"(codes shape {tuple(wp.shape)}, K={k}); expected 1, 2 or 4")
    return 8 // per, per


def dequant_leaf(wp: torch.Tensor, qscale: torch.Tensor, k: int) -> torch.Tensor:
    """Packed node -> f32 weights (the reference leaf view; serving runs
    the qmm kernels instead). ``k`` is the original reduction dim."""
    bits, _ = code_layout(wp, k)
    codes = unpack_int(wp, bits, k, axis=-2).to(torch.float32)
    g_rows = qscale.shape[-2]
    n = codes.shape[-1]
    cg = codes.reshape(*codes.shape[:-2], g_rows, k // g_rows, n)
    w = cg * qscale[..., :, None, :]
    return w.reshape(codes.shape)


def rtn_codes(w: torch.Tensor, bits: int, group: Optional[int] = None, *,
              divide: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric minmax RTN -> (unpacked int8 codes, f32 scales).

    w: (…, K, N); scales are per-(group, out-channel), and ``group``
    falls back to per-channel when it does not divide K. The step is
    ``amax * f32(1/qmax)``, a multiply by the f32 reciprocal: that is
    what the JAX package's jitted ``quantize_tree`` computes (XLA rewrites
    the division by a constant), so scales agree bit for bit.
    ``divide=True`` takes ``amax / qmax`` instead, as the JAX package's
    eager callers do (its mixed-precision ``rtn_mixed_artifact``).
    """
    k, n = w.shape[-2], w.shape[-1]
    g = group if (group and k % group == 0) else k
    qmax = 2 ** (bits - 1) - 1
    wg = w.to(torch.float32).reshape(*w.shape[:-2], k // g, g, n)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    if divide:
        step = amax / qmax
    else:
        step = amax * torch.tensor(np.float32(1.0) / np.float32(qmax), device=w.device)
    scale = torch.clamp_min(step, 1e-8)
    codes = torch.clamp(torch.round(wg / scale), -(2 ** (bits - 1)), qmax)
    return codes.reshape(w.shape).to(torch.int8), scale.squeeze(-2)


def rtn_pack_leaf(w: torch.Tensor, bits: int, group: Optional[int] = None, *,
                  divide: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rtn_codes` + :func:`pack_codes`: (packed codes, scales)."""
    codes, scales = rtn_codes(w, bits, group, divide=divide)
    return pack_codes(codes, w.shape[-2], bits), scales


def _leaf_plan(node: dict, keypath: tuple, bits: int):
    """Packing decision for one dict node: ``('embed', 8)``,
    ``('linear', b)`` or ``None`` (pass through). Already-packed nodes
    are never re-quantized."""
    if "table" in node and "table_qscale" not in node:
        return ("embed", 8)
    if ("w" in node and "qscale" not in node
            and getattr(node["w"], "ndim", 0) >= 2
            and (not keypath or keypath[-1] not in SKIP_KEYS)):
        return ("linear", 8 if keypath and keypath[0] in EIGHT_BIT_ROOTS else bits)
    return None


def quantize_tree(params: Params, bits: int, group: Optional[int] = None
                  ) -> Params:
    """Calibration-free RTN packing of a whole params tree.

    Every linear node ``{"w": (…, K, N)}`` becomes ``{"w": int8,
    "qscale": f32}``; the embedding table becomes int8 with a
    per-channel ``table_qscale``. Embed/head stay 8-bit, the MoE router
    stays FP, 1-D leaves pass through, packed nodes are left alone.
    """

    def walk(node, keypath):
        if not isinstance(node, dict):
            return node
        plan = _leaf_plan(node, keypath, bits)
        if plan is None:
            return {k: walk(v, keypath + (k,)) for k, v in node.items()}
        kind, b = plan
        out = dict(node)
        if kind == "embed":
            out["table"], out["table_qscale"] = rtn_pack_leaf(node["table"], b, None)
        else:
            out["w"], out["qscale"] = rtn_pack_leaf(node["w"], b, group)
        return out

    return walk(params, ())


def rtn_bits_by_path(params: Params, bits: int) -> dict[str, int]:
    """'/'-joined path -> code bits for the leaves :func:`quantize_tree`
    would pack (same :func:`_leaf_plan` predicate as the packing walk)."""

    def walk(node, keypath, out):
        if not isinstance(node, dict):
            return
        plan = _leaf_plan(node, keypath, bits)
        if plan is not None:
            kind, b = plan
            suffix = ("table",) if kind == "embed" else ()
            out["/".join(keypath + suffix)] = b
            return
        for key, v in node.items():
            walk(v, keypath + (key,), out)

    out: dict[str, int] = {}
    walk(params, (), out)
    return out


def tree_bytes(tree) -> int:
    """Physical bytes of every tensor leaf (int8 counts 1 byte/value)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# integrity: per-leaf checksums + content digest (artifact schema v2)
# ---------------------------------------------------------------------------


def leaf_crc32(arr) -> int:
    """crc32 over a leaf's numpy dtype/shape header + raw bytes."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(arr)
    crc = zlib.crc32(f"{a.dtype.str}{a.shape}".encode())
    return zlib.crc32(a.tobytes(), crc) & 0xFFFFFFFF


def tree_checksums(tree) -> dict[str, int]:
    """Flat '/'-joined leaf path -> :func:`leaf_crc32`, in the key layout
    the checkpoint layer stores."""
    return {k: leaf_crc32(v) for k, v in flatten_paths(tree).items()}


def content_digest(checksums: dict[str, int]) -> str:
    """Order-independent digest of the whole artifact's leaf checksums."""
    h = hashlib.sha256()
    for key in sorted(checksums):
        h.update(f"{key}:{checksums[key]}\n".encode())
    return h.hexdigest()
