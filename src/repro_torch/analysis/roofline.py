"""Roofline terms of a whole step on one NVIDIA H100 SXM.

The port of the JAX package's ``repro.analysis.roofline``, whose
constants are a TPU v5e's. The formulas are the reference's, unchanged:

  MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params
  ideal decode bytes = active weights streamed once + the live cache read
  once

Terms of a step (seconds, per device): compute = FLOPs / PEAK_FLOPS,
memory = bytes / HBM_BW, collective = collective bytes / LINK_BW.

The reference reads FLOPs, bytes and collective bytes from a compiled XLA
module (``from_hlo``); the port compiles no XLA, so :func:`from_hlo` has
no counterpart. :func:`from_trace` takes the three totals from the dry
run's DTensor trace (``launch/dryrun.py``), and :func:`from_step` from one
measured eager step (``analysis/optrace.analyze_step``).
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
from ..dist.sharding import estimate_params

# NVIDIA H100 SXM5 80 GB, data sheet (dense rates, no sparsity):
HBM_BW = 3.35e12  # B/s, HBM3
PEAK_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
PEAK_TF32 = 495e12  # TF32 on the tensor cores
PEAK_F32 = 67e12  # f32 on the CUDA cores
LINK_BW = 450e9  # B/s one way: NVLink 4, 900 GB/s bidirectional per GPU


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_chip: float
    hlo_flops_per_chip: float
    useful_ratio: float  # MODEL_FLOPS / measured FLOPs
    roofline_frac: float  # useful compute time / dominant term
    mem_frac: float = 0.0  # decode: ideal (params+cache once) / measured bytes

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def ideal_serve_bytes(cfg: ArchConfig, shape: ShapeSpec, n_chips: int,
                      w_bits: int = 16) -> float:
    """Per-device lower bound for one decode step: stream the active
    weights once + read the live cache once (both sharded over devices)."""
    param_bytes = active_params(cfg) * w_bits / 8.0
    B, S = shape.global_batch, shape.seq_len
    hd, K = cfg.hd, cfg.n_kv_heads
    if cfg.family == "ssm":
        di = int(cfg.d_model * cfg.xlstm_expansion)
        H = cfg.n_heads
        cache = cfg.n_layers * B * (H * (di // max(H, 1)) ** 2) * 4.0
    else:
        cache = 0.0
        slots = S
        win = cfg.window or (cfg.hymba_window if cfg.family == "hybrid" else None)
        if cfg.local_global:
            nl, ng = cfg.local_global
            per_group = nl * min(S, cfg.local_window) + ng * S
            slots_total = per_group * (cfg.n_layers // (nl + ng))
            cache = B * slots_total * K * hd * 2 * 2.0
            slots = None
        elif win:
            slots = min(S, win)
        if slots is not None:
            cache = cfg.n_layers * B * slots * K * hd * 2 * 2.0
        if cfg.family == "hybrid":
            di = int(cfg.d_model * cfg.ssm_expansion)
            cache += cfg.n_layers * B * di * cfg.ssm_state * 4.0
    return (param_bytes + cache) / n_chips


def active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (MoE: top-k + shared experts only)."""
    total = estimate_params(cfg)
    if cfg.moe:
        d = cfg.d_model
        expert = 3 * d * cfg.moe.d_ff_expert
        inactive = (cfg.moe.n_experts - cfg.moe.top_k) * expert
        n_moe_layers = cfg.n_layers - cfg.moe.first_k_dense
        total -= n_moe_layers * inactive
    return total


def model_flops(cfg: ArchConfig, shape: ShapeSpec, n_chips: int) -> float:
    """6*N_active*D for train; 2*N_active*D for inference, per device.

    Decode shapes process global_batch tokens per step (D = batch)."""
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens / n_chips
    tokens = shape.global_batch  # one token per sequence per step
    return 2.0 * n * tokens / n_chips


def from_trace(flops: float, bytes_: float, collective_bytes: float, cfg: ArchConfig,
               shape: ShapeSpec, n_chips: int, w_bits: int = 16) -> Roofline:
    """The roofline of one step from the dry run's trace (``launch/dryrun``):
    FLOPs, bytes and collective bytes per device, on one H100. The fields
    and their arithmetic are the reference's ``from_hlo``; only the source
    of the three totals differs (a DTensor trace in place of XLA's HLO)."""
    compute = flops / PEAK_FLOPS
    memory = bytes_ / HBM_BW
    collective = collective_bytes / LINK_BW
    terms = {"compute": compute, "memory": memory, "collective": collective}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, n_chips)
    useful = mf / flops if flops else 0.0
    dominant = max(terms.values())
    mem_frac = (ideal_serve_bytes(cfg, shape, n_chips, w_bits) / bytes_
                if shape.kind == "decode" and bytes_ else 0.0)
    return Roofline(compute_s=compute, memory_s=memory, collective_s=collective,
                    bottleneck=bottleneck, model_flops_per_chip=mf,
                    hlo_flops_per_chip=flops, useful_ratio=useful,
                    roofline_frac=(mf / PEAK_FLOPS) / dominant if dominant else 0.0,
                    mem_frac=mem_frac)


def from_step(summary, cfg: ArchConfig, shape: ShapeSpec, n_chips: int,
              w_bits: int = 16) -> Roofline:
    """The roofline of one measured eager step: :func:`from_trace` over the
    FLOPs, bytes and collective bytes of an ``optrace.StepSummary``
    (``analysis/optrace.analyze_step``), the counterpart of the reference's
    ``from_hlo`` over an ``HLOSummary``."""
    return from_trace(summary.flops, summary.bytes, summary.collective_bytes, cfg, shape,
                      n_chips, w_bits)


def from_hlo(hlo_text: str, cfg: ArchConfig, shape: ShapeSpec,
             n_chips: int, w_bits: int = 16):
    """The reference parses a compiled XLA module here. The port compiles
    none (ROADMAP 15c/15d): a measured step's terms come from
    ``optrace.analyze_step`` and :func:`from_step`, the dry run's from
    :func:`from_trace`."""
    raise NotImplementedError(
        "from_hlo parses XLA HLO, which the port does not compile (ROADMAP 15c/15d): "
        "summarise a step with repro_torch.analysis.optrace.analyze_step and take its "
        "roofline with roofline.from_step (a dry run's: roofline.from_trace)")
