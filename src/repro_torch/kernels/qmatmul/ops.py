"""Shape-driven tier dispatcher for the packed dequant-matmul.

``qmm(x, qw)`` consumes a :class:`QuantizedLinear` (from
:func:`pack_weights` / :func:`from_node`) and routes it by shape alone:

  decode    M <= DECODE_M_MAX rows (a decode step's batch): ``qgemv``
  prefill   everything else 2-D: ``qmatmul``
  grouped   stacked expert nodes (packed.ndim == 3): ``qmatmul_grouped``
            over (E, rows per expert, K) activations

``backend`` picks how a tier runs: ``'cuda'`` launches the hand-written
kernel (and raises on CPU tensors), ``'torch'`` runs the plain PyTorch
version, ``'auto'`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors. The CUDA kernels mask ragged M and N, so
no padding happens here. The plain grouped version loops over the experts
for decode-shaped calls (<= DECODE_M_MAX rows per expert, one expert's
(K, N) unpacked at a time) and dequantizes (E, K, N) once above that.

The decode-tier override (:func:`set_decode_tier`,
``REPRO_QMM_DECODE_TIER``) and the measured dispatch table
(:func:`set_dispatch_table`, ``REPRO_QMM_DISPATCH``) behave as in the JAX
package's ``repro.kernels.qmatmul.ops``.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ...core.quantizer import pack_int
from ...deploy.pack import code_layout
from . import kernel
from .ref import qgemv_ref, qmatmul_ref, qmm_grouped_dense_ref, qmm_grouped_ref

# Largest row count served by the decode tier.
DECODE_M_MAX = 8

BACKENDS = ("auto", "torch", "cuda")

# Decode-tier opt-out:
#   env   REPRO_QMM_DECODE_TIER=0|false|off|no
#   code  set_decode_tier(False)              (overrides the env)
_FALSY = ("0", "false", "off", "no")
_DECODE_TIER_FORCED: bool | None = None


def _env_decode_tier() -> bool:
    return os.environ.get("REPRO_QMM_DECODE_TIER", "1").lower() not in _FALSY


def decode_tier_enabled() -> bool:
    """Whether decode-shaped matmuls may use the gemv tier."""
    if _DECODE_TIER_FORCED is not None:
        return _DECODE_TIER_FORCED
    return _env_decode_tier()


def set_decode_tier(enabled: bool | None) -> None:
    """Force the decode tier on/off (``None`` returns control to the
    ``REPRO_QMM_DECODE_TIER`` env var). Takes effect at the next call."""
    global _DECODE_TIER_FORCED
    _DECODE_TIER_FORCED = enabled


# Measured dispatch: (K, N, container_bits) -> winning tier overrides the
# M-threshold guess for the decode shapes it covers.
#   env   REPRO_QMM_DISPATCH=heuristic|measured  (forces the mode)
#   auto  (default): measured iff a table is installed
_DISPATCH_TABLE: dict[tuple[int, int, int], str] | None = None


def set_dispatch_table(table: dict[tuple[int, int, int], str] | None) -> None:
    """Install (or clear) the measured dispatch table."""
    global _DISPATCH_TABLE
    _DISPATCH_TABLE = table


def dispatch_mode() -> str:
    """The ``REPRO_QMM_DISPATCH`` env override when set, else
    ``'measured'`` iff a table is installed."""
    mode = os.environ.get("REPRO_QMM_DISPATCH", "auto").lower()
    if mode in ("heuristic", "measured"):
        return mode
    return "measured" if _DISPATCH_TABLE else "heuristic"


# Tier counters (reset with ``reset_tier_counts``): every qmm call bumps
# its tier once. Kernel launches are counted apart, in kernel.LAUNCHES.
TIER_COUNTS = {"decode": 0, "prefill": 0, "grouped": 0}


def reset_tier_counts() -> None:
    for k in TIER_COUNTS:
        TIER_COUNTS[k] = 0


class PackedNodeError(TypeError):
    """A params node does not have the packed layout qmm consumes."""


@dataclasses.dataclass
class QuantizedLinear:
    """Deployment weight format: packed codes + per-group scales.

      packed  (K * bits/8, N) int8        or stacked (E, K * bits/8, N)
      scales  (G, N) f32                  or (E, G, N), or (1, G, N) shared
                                          by every expert
    """

    packed: torch.Tensor
    scales: torch.Tensor
    bits: int
    k: int  # original reduction dim


def pack_weights(codes: torch.Tensor, scales, bits: int) -> QuantizedLinear:
    """codes: (K, N) int8 in [-2^{b-1}, 2^{b-1}-1]; scales broadcastable."""
    k, n = codes.shape
    scales = torch.as_tensor(scales, dtype=torch.float32,
                             device=codes.device).reshape(-1, n)
    return QuantizedLinear(pack_int(codes, bits), scales, bits, k)


def from_node(node, k: int, path: str | None = None) -> QuantizedLinear:
    """View a packed params node as a :class:`QuantizedLinear`. ``k`` is
    the original reduction dim; container bits are inferred from the
    packed row count; ``path`` names the node in errors."""
    wp, scales = node["w"], node["qscale"]
    where = f" at {path!r}" if path else ""
    if wp.ndim not in (2, 3):
        raise PackedNodeError(
            f"packed node{where}: codes must be 2-D (K*bits/8, N) or "
            f"stacked 3-D (E, K*bits/8, N), got shape {tuple(wp.shape)}")
    if scales.ndim != wp.ndim:
        raise PackedNodeError(
            f"packed node{where}: qscale rank {scales.ndim} does not match "
            f"codes rank {wp.ndim} (shapes {tuple(scales.shape)} vs "
            f"{tuple(wp.shape)})")
    try:
        bits, _ = code_layout(wp, k)
    except ValueError as e:
        raise PackedNodeError(f"packed node{where}: {e}") from None
    return QuantizedLinear(wp, scales, bits, k)


def select_tier(m: int, qw: QuantizedLinear) -> str:
    """Execution tier for ``m`` activation rows against ``qw``. The
    decode-tier opt-out wins over everything; decode shapes consult the
    measured table in ``'measured'`` mode, else take the gemv guess."""
    if qw.packed.ndim == 3:
        return "grouped"
    if m > DECODE_M_MAX or not decode_tier_enabled():
        return "prefill"
    if _DISPATCH_TABLE is not None and dispatch_mode() == "measured":
        tier = _DISPATCH_TABLE.get((qw.k, qw.packed.shape[-1], qw.bits))
        if tier is not None:
            return tier
    return "decode"


def _qmm_2d(x2: torch.Tensor, qw: QuantizedLinear, backend: str,
            tier: str) -> torch.Tensor:
    if backend == "torch":
        ref = qgemv_ref if tier == "decode" else qmatmul_ref
        return ref(x2, qw.packed, qw.scales, qw.bits)
    fn = kernel.qgemv if tier == "decode" else kernel.qmatmul
    return fn(x2, qw.packed, qw.scales, bits=qw.bits)


def _qmm_grouped(x: torch.Tensor, qw: QuantizedLinear,
                 backend: str) -> torch.Tensor:
    """x (..., E, C, K) @ stacked qw (E, K*bits/8, N) -> (..., E, C, N)."""
    if x.ndim < 3:
        raise PackedNodeError(
            f"grouped qmm: stacked codes {tuple(qw.packed.shape)} need (..., E, "
            f"C, K) activations, got rank-{x.ndim} {tuple(x.shape)}")
    e, c, k = x.shape[-3], x.shape[-2], x.shape[-1]
    if e != qw.packed.shape[0] or k != qw.k:
        raise PackedNodeError(
            f"grouped qmm: activations (..., E={e}, C={c}, K={k}) do not "
            f"match stacked codes {tuple(qw.packed.shape)} (E, K*bits/8, N)")
    lead = x.shape[:-3]
    scales = qw.scales
    if scales.shape[0] == 1 and e > 1:
        # one (G, N) set shared by every expert, as a calibrated export's
        # per-channel scales are: each expert reads its own copy
        scales = scales.expand(e, *scales.shape[1:]).contiguous()
    # (..., E, C, K) -> (E, B'*C, K): experts become the leading grid dim
    xg = x.reshape(-1, e, c, k).transpose(0, 1).reshape(e, -1, k).contiguous()
    if backend == "torch":
        ref = (qmm_grouped_ref if xg.shape[1] <= DECODE_M_MAX
               else qmm_grouped_dense_ref)
        out = ref(xg, qw.packed, scales, qw.bits)
    else:
        out = kernel.qmatmul_grouped(xg, qw.packed, scales, bits=qw.bits)
    n = out.shape[-1]
    return out.reshape(e, -1, c, n).transpose(0, 1).reshape(*lead, e, c, n)


def qmm(x: torch.Tensor, qw: QuantizedLinear, *,
        backend: str = "auto") -> torch.Tensor:
    """Packed dequant-matmul ``x @ dequant(qw)``, tier picked by shape.

    x: (..., K) f32; leading dims are flattened to M rows and restored.
    For a stacked ``qw`` (E, K*bits/8, N): x (..., E, C, K), with C rows
    per expert. Returns f32 (..., N), or (..., E, C, N) when stacked.
    """
    if backend not in BACKENDS:
        raise ValueError(f"qmm backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if x.is_cuda else "torch"
    if qw.packed.ndim == 3:
        TIER_COUNTS["grouped"] += 1
        return _qmm_grouped(x, qw, backend)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qw.k).contiguous()
    tier = select_tier(x2.shape[0], qw)
    TIER_COUNTS[tier] += 1
    return _qmm_2d(x2, qw, backend, tier).reshape(*lead, -1)
