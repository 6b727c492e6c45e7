"""BRECQ block reconstruction engine (paper Alg. 1).

The port of the JAX package's ``repro.core.reconstruction``. Pipeline:
  1. Enumerate quantizable weights by walking the model once.
  2. Capture the FP activation stream and, with one backward pass per
     calibration batch (epsilon trick), the diagonal Fisher at every
     block output.
  3. Partition blocks into reconstruction units: layer / block / stage /
     net (Sec. 3.2). Units never cross the enc->dec boundary.
  4. Per unit: optimize AdaRound logits (+ LSQ activation step sizes)
     with Adam on the Fisher-weighted output MSE + beta-annealed rounding
     regularizer. Inputs come from the quantized stream; targets from the
     FP stream.
  5. Harden rounding, advance the quantized stream, continue.
  6. Bake hard-quantized weights back into a params copy for serving.

Everything runs where the params are (``interop.params_from_numpy(...,
device=)``); the calibration batches are moved there. The hardened
forward and ``bake`` run K5 (``kernels/fakequant``) on the card, the
MoE experts' stacked (E, K, N) weights included. The port builds every
family of the JAX package: dense, MoE (a MoE unit spans the ``dense0``
and ``moe`` stacks through the same walker, and the router's aux loss is
dropped, as in JAX), VLM (a unit's cross-attention reads
``batch["patches"]``), encoder-decoder (the encoder units, then the
boundary, the encoder's norm and the token embedding, in f32, then the
decoder units over the memory) and the recurrent ones (xLSTM, hymba). A
recurrent block runs its parallel form over the whole calibration
sequence from the zero state, as in JAX, so no state crosses a unit
boundary and the walker needs no branch for it; AdaRound's gradient flows
through the scans.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..interop import tree_leaves, tree_map
from ..launch.watchdog import GracefulShutdown, StepWatchdog
from ..models.common import NO_QUANT, Ctx, QuantHook, softmax_xent
from ..optim import adam
from . import adaround, calib_loop, lsq
from .adaround import BetaSchedule
from .fisher import FisherStream
from .hooks import RTNHook
from .journal import CalibJournal, CalibrationInterrupted
from .quantizer import QConfig, QState, init_qstate, quantize_dequant

Params = Any


def _layer_params(params, stack, ri: int):
    return tree_map(lambda a: a[ri], params[stack.name])


# ---------------------------------------------------------------------------
# model walker: python-level block-by-block execution
# ---------------------------------------------------------------------------


def _positions(seqs: torch.Tensor) -> torch.Tensor:
    B, S = seqs.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=seqs.device).expand(B, S)


class Walker:
    """Sequential execution of a model's block graph: an encoder-decoder
    model's encoder blocks, then its decoder blocks (``enc_n`` the
    boundary), else the model's stacks in order."""

    def __init__(self, model):
        self.model = model
        self.encdec = hasattr(model, "enc_stack")
        self.enc_n = self.model.enc_stack.n if self.encdec else 0

    def blocks(self) -> list[tuple[Any, int]]:
        if self.encdec:
            stacks = [self.model.enc_stack, self.model.dec_stack]
        else:
            stacks = self.model.stacks
        return [(s, i) for s in stacks for i in range(s.n)]

    def block_path(self, bi: int) -> str:
        stack, ri = self.blocks()[bi]
        return f"{stack.name}.{ri}"

    def stem(self, params, batch, quant=NO_QUANT):
        """Activations entering block 0 (+ its ctx)."""
        if self.encdec:
            frames = batch["frames"]
            ctx = Ctx(cfg=self.model.cfg, positions=_positions(frames), quant=quant)
            return frames + params["enc_pos"][:frames.shape[1]], ctx
        return self.model.begin(params, batch, quant)

    def ctx_for(self, batch, bi: int, memory, quant=NO_QUANT) -> Ctx:
        """Ctx entering block ``bi`` given the stream's encoder memory."""
        cfg = self.model.cfg
        if self.encdec and bi < self.enc_n:
            return Ctx(cfg=cfg, positions=_positions(batch["frames"]), quant=quant)
        ctx = Ctx(cfg=cfg, positions=_positions(batch["tokens"]), quant=quant)
        if self.encdec:
            ctx.extras["memory"] = memory
        elif cfg.family == "vlm":
            ctx.extras["memory"] = batch["patches"]
        return ctx

    def apply_block(self, params, bi: int, x, ctx, quant=NO_QUANT):
        stack, ri = self.blocks()[bi]
        ctx2 = dataclasses.replace(ctx, quant=quant, scope=self.block_path(bi))
        y, _ = self.model.apply_block(ctx2, stack, _layer_params(params, stack, ri), x)
        return y

    def boundary_transition(self, params, batch, x, quant=NO_QUANT):
        """The encoder's output -> (memory, the decoder's stem x)."""
        from ..models import common as cm
        from ..models.transformer import _norm

        memory = _norm(self.model.cfg, params["enc_norm"], x)
        ctx = Ctx(cfg=self.model.cfg, positions=_positions(batch["tokens"]),
                  quant=quant if quant is not None else NO_QUANT)
        # embed_lookup (not a raw table gather) so a packed int8 table
        # from a deployment artifact dequantizes here too
        return memory, cm.embed_lookup(ctx, params["embed"], batch["tokens"])

    def run(self, params, batch, quant=NO_QUANT, eps: Optional[list] = None):
        """Full forward block-by-block (eval and the Fisher pass). ``eps``
        is an optional per-block list of output perturbations; ``None``
        entries are skipped."""
        x, ctx = self.stem(params, batch, quant)
        for bi in range(len(self.blocks())):
            x = self.apply_block(params, bi, x, ctx, quant)
            if eps is not None and eps[bi] is not None:
                x = x + eps[bi]
            if self.encdec and bi == self.enc_n - 1:
                memory, x = self.boundary_transition(params, batch, x, quant)
                ctx = self.ctx_for(batch, bi + 1, memory, quant)
        return self.model.finish(params, x, ctx)

    def loss(self, params, batch, quant=NO_QUANT, eps=None):
        logits = self.run(params, batch, quant, eps)
        tokens = batch["tokens"]
        return softmax_xent(logits[:, :-1], tokens[:, 1:])


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    """Static configuration for one BRECQ calibration run; the fields and
    defaults of the JAX package's ``ReconConfig``.

    Attributes:
      w_bits: weight bit-width for block weights (embed/head: see
        ``keep_embed_head_8bit``).
      a_bits: activation bit-width; ``None`` = weight-only PTQ.
      w_group: per-group weight quantization along the reduction axis;
        ``None`` keeps per-channel scales.
      scale_method: scale init, ``'minmax'`` or ``'mse'``.
      iters: AdaRound/LSQ optimization iterations per unit.
      calib_bs: minibatch size (sequences) drawn per iteration.
      lr_v / lr_s: Adam learning rates of the rounding logits / LSQ steps.
      granularity: ``'layer'``, ``'block'`` (paper default), ``'stage'``
        or ``'net'``.
      n_stages: stages per segment at ``granularity='stage'``.
      use_fisher: weight the unit output MSE by the diagonal FIM (ignored
        at ``granularity='layer'``).
      keep_embed_head_8bit: embed table and LM head at 8 bits.
      lam / beta: weight and annealing schedule of the rounding regularizer.
      input_source: unit inputs from the ``'quant'`` stream, the ``'fp'``
        stream, or a per-sequence ``'mix'`` (prob ``input_mix_prob``).
      per_layer_bits: optional path -> bits override (mixed precision).
      seed: seeds the per-unit minibatch generators.
      loop_impl: ``'scan'`` (one trajectory fetch per unit) or
        ``'python'`` (a sync per iteration; the reference mode).
      stream_dtype: storage dtype of the activation streams and the
        streamed Fisher: ``'bfloat16'`` or ``'float32'`` (exact reference).
        Compute is always f32.
      fisher_mode: ``'stream'`` (per unit on demand) or ``'full'``.
      unit_guard, unit_retries, retry_lr_decay, mse_guard_ratio: the
        per-unit health guard: a non-finite trace or an MSE worse than the
        unit's RTN baseline times ``mse_guard_ratio`` retries from the
        initial state at a decayed lr, and after ``unit_retries`` failed
        retries the unit degrades to RTN. A CUDA out-of-memory error
        during the optimization retries with a halved minibatch.
    """

    w_bits: int = 4
    a_bits: Optional[int] = None
    w_group: Optional[int] = None
    scale_method: str = "mse"
    iters: int = 800
    calib_bs: int = 8
    lr_v: float = 1e-3
    lr_s: float = 4e-5
    granularity: str = "block"  # layer | block | stage | net
    n_stages: int = 4
    use_fisher: bool = True
    keep_embed_head_8bit: bool = True
    lam: float = 0.01
    beta: BetaSchedule = dataclasses.field(default_factory=BetaSchedule)
    input_source: str = "quant"  # 'quant' | 'fp' | 'mix'
    input_mix_prob: float = 0.5
    per_layer_bits: Optional[dict] = None
    seed: int = 0
    loop_impl: str = "scan"  # 'scan' | 'python' (reference)
    stream_dtype: str = "bfloat16"  # 'bfloat16' | 'float32' (reference)
    fisher_mode: str = "stream"  # 'stream' | 'full' (reference)
    unit_guard: bool = True
    unit_retries: int = 2
    retry_lr_decay: float = 0.5
    mse_guard_ratio: float = 1.5


@dataclasses.dataclass
class PTQResult:
    params_q: Params
    act_scales: dict  # path -> scalar ({} when a_bits is None)
    qstates: dict  # path -> (QState, QConfig)
    v: dict  # path -> rounding logits
    stats: dict


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _concat_batches(batches: list[dict]) -> dict:
    return {k: torch.cat([b[k] for b in batches], 0) for k in batches[0]}


def _slice_batch(batch: dict, idx) -> dict:
    return {k: v[idx] for k, v in batch.items()}


class _ValHook(QuantHook):
    def __init__(self):
        self.vals: dict[str, torch.Tensor] = {}

    def weight(self, path, w):
        self.vals[path] = w
        return w


def enumerate_weights(model, params, batch) -> dict[str, torch.Tensor]:
    """path -> weight tensor for every quant-eligible weight."""
    hook = _ValHook()
    with torch.no_grad():
        Walker(model).run(params, batch, hook)
    return hook.vals


def _bits_for(rc: ReconConfig, path: str) -> int:
    if rc.per_layer_bits and path in rc.per_layer_bits:
        return rc.per_layer_bits[path]
    return rc.w_bits


def init_states(model, weights: dict[str, torch.Tensor], rc: ReconConfig):
    """Quantizer state for block weights + 8-bit embed/head handling."""
    qstates: dict[str, tuple[QState, QConfig]] = {}
    embed_head: dict[str, tuple[QState, QConfig]] = {}
    for path, w in weights.items():
        if path in ("embed/table", "head/w"):
            if not rc.keep_embed_head_8bit:
                continue
            if path == "head/w" and model.cfg.tie_embeddings:
                continue  # tied: baking the embed covers the head
            cfg = QConfig(bits=8, channel_axis=-1, scale_method="mse")
            embed_head[path] = (init_qstate(w, cfg), cfg)
        else:
            cfg = QConfig(bits=_bits_for(rc, path), channel_axis=-1,
                          group_size=rc.w_group, scale_method=rc.scale_method)
            qstates[path] = (init_qstate(w, cfg), cfg)
    return qstates, embed_head


def _partition(walker: Walker, rc: ReconConfig) -> list[list[int]]:
    nb = len(walker.blocks())
    if rc.granularity in ("layer", "block"):
        return [[i] for i in range(nb)]
    segs = _segments(walker)
    if rc.granularity == "net":
        return segs
    if rc.granularity == "stage":
        units = []
        for seg in segs:
            k = max(1, (len(seg) + rc.n_stages - 1) // rc.n_stages)
            units += [seg[i:i + k] for i in range(0, len(seg), k)]
        return units
    raise ValueError(rc.granularity)


def _segments(walker: Walker) -> list[list[int]]:
    nb = len(walker.blocks())
    if walker.encdec:
        return [list(range(walker.enc_n)), list(range(walker.enc_n, nb))]
    return [list(range(nb))]


def _nbytes(a: Optional[torch.Tensor]) -> int:
    return 0 if a is None else a.numel() * a.element_size()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def quantize(model, params, calib_batches: list[dict], rc: ReconConfig, *,
             workdir: Optional[str] = None) -> PTQResult:
    """Run BRECQ calibration (paper Alg. 1) and return quantized params.

    Args:
      model: a model exposing ``begin`` / ``apply_block`` / ``finish``
        (dense, MoE, VLM, or an ``EncDecLM`` walked encoder first).
      params: FP parameters (never mutated); calibration runs on their
        device.
      calib_batches: list of calibration batches, concatenated into one
        calibration set of N sequences and moved to the params' device.
      rc: :class:`ReconConfig`.
      workdir: optional journal directory making the run resumable: a
        snapshot after every unit; a re-run with the same ``workdir``
        skips completed units and continues bit-identically on the same
        device. While a journal is active, SIGTERM / SIGINT finish the
        current unit, persist it and raise ``CalibrationInterrupted``.

    Returns:
      :class:`PTQResult`; ``stats`` carries the JAX package's keys
      (``calib_wall_s``, ``fisher_wall_s``, ``calib_iters_per_s``,
      ``calib_peak_bytes`` (+ ``_detail``), ``unit_cache``,
      ``probe_cache``, ``unit_retries``, ``unit_fallbacks``,
      ``unit_oom_halvings``, ``stragglers``, ``resumed_at_unit``, per-unit
      ``units``, ...).
    """
    if rc.loop_impl not in ("scan", "python"):
        raise ValueError(f"loop_impl must be 'scan' or 'python', got {rc.loop_impl!r}")
    if rc.fisher_mode not in ("stream", "full"):
        raise ValueError(
            f"fisher_mode must be 'stream' or 'full', got {rc.fisher_mode!r}")
    if rc.stream_dtype not in calib_loop._DTYPES:
        raise ValueError(
            f"stream_dtype must be 'bfloat16' or 'float32', got {rc.stream_dtype!r}")
    sdtype = calib_loop._DTYPES[rc.stream_dtype]
    t0 = time.time()
    walker = Walker(model)
    device = tree_leaves(params)[0].device
    calib_batches = [{k: v.to(device) for k, v in b.items()} for b in calib_batches]
    calib = _concat_batches(calib_batches)
    cache0 = calib_loop.cache_stats()

    probe = _slice_batch(calib, slice(0, 1))
    weights = enumerate_weights(model, params, probe)
    qstates, embed_head = init_states(model, weights, rc)
    q_stem_hook = RTNHook(embed_head)

    # diagonal Fisher at block outputs (FP model, eps trick): 'stream'
    # computes g^2 per unit on demand, 'full' precomputes every block here
    fisher: Optional[FisherStream] = None
    if rc.use_fisher and rc.granularity != "layer":
        fisher = FisherStream(walker, params, calib_batches,
                              mode=rc.fisher_mode, dtype=sdtype)

    units = _partition(walker, rc)

    journal: Optional[CalibJournal] = None
    shutdown: Optional[GracefulShutdown] = None
    snap = None
    if workdir is not None:
        sig = {"rc": repr(rc), "arch": getattr(model.cfg, "name", None),
               "n_units": len(units),
               "calib": str({k: (tuple(v.shape), str(v.dtype))
                             for k, v in calib.items()})}
        journal = CalibJournal(workdir, sig)
        snap = journal.load()
        shutdown = GracefulShutdown()

    start_unit = 0
    v_all: dict[str, torch.Tensor] = {}
    s_all: dict[str, torch.Tensor] = {}
    stats: dict = {"units": [], "granularity": rc.granularity}
    stream_peak = 0
    mem_fp = mem_q = None
    if snap is not None:
        # everything a restart cannot recompute comes from the journal
        start_unit = snap["next_unit"]
        x_fp, x_q = snap["x_fp"].to(device), snap["x_q"].to(device)
        mem_fp, mem_q = (None if m is None else m.to(device)
                         for m in (snap["mem_fp"], snap["mem_q"]))
        v_all = {k: v.to(device) for k, v in snap["v_all"].items()}
        s_all = {k: v.to(device) for k, v in snap["s_all"].items()}
        stats["units"] = [_revive_unit_stat(u) for u in snap["unit_stats"]]
        stream_peak = snap["stream_peak"]
        stats["resumed_at_unit"] = start_unit
    else:
        with torch.no_grad():
            x_fp = walker.stem(params, calib)[0].to(sdtype)
            x_q = walker.stem(params, calib, q_stem_hook)[0].to(sdtype)

    wd = StepWatchdog(label="unit")
    try:
        for ui in range(start_unit, len(units)):
            unit = units[ui]
            gen = calib_loop.unit_generator(rc.seed, ui, device)
            wd.start()
            # while a unit runs, the old and new stream generations coexist
            stream_peak = max(stream_peak, 2 * (_nbytes(x_fp) + _nbytes(x_q))
                              + _nbytes(mem_fp) + _nbytes(mem_q))
            if rc.granularity == "layer":
                x_fp, x_q, v_u, s_u, ustat = _reconstruct_layerwise(
                    model, walker, params, weights, calib, unit[0], x_fp, x_q,
                    mem_fp, mem_q, qstates, rc, gen)
            else:
                x_fp, x_q, v_u, s_u, ustat = _reconstruct_unit(
                    model, walker, params, weights, calib, unit, x_fp, x_q,
                    mem_fp, mem_q, fisher, qstates, rc, gen)
            v_all.update(v_u)
            s_all.update(s_u)
            stats["units"].append(ustat)
            # enc->dec boundary between units (computed in f32, stored
            # back in the stream dtype)
            if walker.encdec and max(unit) == walker.enc_n - 1:
                with torch.no_grad():
                    mem_fp, x_fp = walker.boundary_transition(
                        params, calib, x_fp.to(torch.float32))
                    mem_q, x_q = walker.boundary_transition(
                        params, calib, x_q.to(torch.float32), q_stem_hook)
                mem_fp, x_fp = mem_fp.to(sdtype), x_fp.to(sdtype)
                mem_q, x_q = mem_q.to(sdtype), x_q.to(sdtype)
            wd.stop(ui)
            if journal is not None:
                # snapshot after the boundary, so a resume starts where
                # this iteration left off
                journal.save(ui + 1, x_fp, x_q, mem_fp, mem_q, v_all, s_all,
                             stats["units"], stream_peak)
                if shutdown.requested and ui + 1 < len(units):
                    raise CalibrationInterrupted(journal.workdir, ui + 1,
                                                 len(units))
    finally:
        if shutdown is not None:
            shutdown.restore()

    params_q = bake(model, params, qstates, v_all, embed_head)
    cache1 = calib_loop.cache_stats()
    opt_iters = sum(u.get("opt_iters", 0) for u in stats["units"])
    opt_wall = sum(u.get("opt_wall_s", 0.0) for u in stats["units"])
    fisher_bytes = fisher.peak_bytes if fisher is not None else 0
    stats.update(
        calib_wall_s=time.time() - t0, n_units=len(units),
        n_weights=len(qstates), loop_impl=rc.loop_impl,
        stream_dtype=rc.stream_dtype, fisher_mode=rc.fisher_mode,
        fisher_wall_s=fisher.wall_s if fisher is not None else 0.0,
        calib_peak_bytes=stream_peak + fisher_bytes,
        calib_peak_bytes_detail={"streams": stream_peak, "fisher": fisher_bytes},
        calib_iters_per_s=opt_iters / max(opt_wall, 1e-9),
        unit_cache={"hits": cache1["unit_hits"] - cache0["unit_hits"],
                    "misses": cache1["unit_misses"] - cache0["unit_misses"]},
        probe_cache={"hits": cache1["probe_hits"] - cache0["probe_hits"],
                     "misses": cache1["probe_misses"] - cache0["probe_misses"]},
        stragglers=wd.stragglers,
        unit_retries=sum(int(u.get("retries", 0)) for u in stats["units"]),
        unit_fallbacks=sum(1 for u in stats["units"] if u.get("fallback")),
        unit_oom_halvings=sum(int(u.get("oom_halvings", 0))
                              for u in stats["units"]))
    if rc.granularity == "layer":
        stats["layer_cache"] = {
            "hits": cache1["layer_hits"] - cache0["layer_hits"],
            "misses": cache1["layer_misses"] - cache0["layer_misses"]}
        stats["cap_cache"] = {
            "hits": cache1["cap_hits"] - cache0["cap_hits"],
            "misses": cache1["cap_misses"] - cache0["cap_misses"]}
    all_states = dict(qstates)
    all_states.update(embed_head)
    hist: dict[str, int] = {}
    for _p, (_st, qcfg) in all_states.items():
        hist[str(qcfg.bits)] = hist.get(str(qcfg.bits), 0) + 1
    stats.update(w_bits=rc.w_bits, a_bits=rc.a_bits, w_group=rc.w_group,
                 bits_histogram=hist)
    return PTQResult(params_q=params_q, act_scales=s_all, qstates=all_states,
                     v=v_all, stats=stats)


def _revive_unit_stat(u: dict) -> dict:
    """Journal round-trip: loss traces are JSON lists on disk, ndarrays
    in live stats."""
    u = dict(u)
    if isinstance(u.get("loss_trace"), list):
        u["loss_trace"] = np.asarray(u["loss_trace"])
    return u


def _apply_unit(walker, params, unit, hook, x, batch, memory):
    """Run the unit's contiguous blocks under ``hook`` (block paths as
    the hook's scope)."""
    ctx = walker.ctx_for(batch, min(unit), memory)
    for bi in sorted(unit):
        x = walker.apply_block(params, bi, x, ctx, hook)
    return x


# ---------------------------------------------------------------------------
# block / stage / net units
# ---------------------------------------------------------------------------


def _unit_canon(walker, unit: list[int]):
    """Canonical naming for a unit: block ``j`` runs under scope ``u{j}``
    regardless of its absolute index."""
    prefixes = [(j, walker.block_path(bi) + "/") for j, bi in enumerate(unit)]

    def canon(p: str) -> str:
        for j, pref in prefixes:
            if p.startswith(pref):
                return f"u{j}/" + p[len(pref):]
        raise KeyError(f"path {p} not inside unit {unit}")

    return canon


def _unit_uncanon(walker, unit: list[int]):
    """Inverse of :func:`_unit_canon`: ``u{j}/rest`` -> real block path."""

    def uncanon(cp: str) -> str:
        j, rest = cp.split("/", 1)
        return walker.block_path(unit[int(j[1:])]) + "/" + rest

    return uncanon


def _unit_pieces(walker, params, unit: list[int]):
    """(bparams, stackdefs, is_dec) — the per-unit inputs of the programs."""
    bparams, stackdefs = [], []
    for bi in unit:
        stack, ri = walker.blocks()[bi]
        bparams.append(_layer_params(params, stack, ri))
        stackdefs.append(stack)
    is_dec = bool(walker.encdec and min(unit) >= walker.enc_n)
    return tuple(bparams), tuple(stackdefs), is_dec


def _clone(tree):
    return {k: {p: t.clone() for p, t in d.items()} for k, d in tree.items()}


def _reconstruct_unit(model, walker, params, weights, calib, unit, x_fp, x_q,
                      mem_fp, mem_q, fisher: Optional[FisherStream], qstates,
                      rc: ReconConfig, gen):
    t0 = time.time()
    N = calib["tokens"].shape[0]
    unit = sorted(unit)

    canon = _unit_canon(walker, unit)
    uncanon = _unit_uncanon(walker, unit)
    bparams, stackdefs, is_dec = _unit_pieces(walker, params, unit)

    b1 = _slice_batch(calib, slice(0, 1))
    m1 = mem_q[:1] if mem_q is not None else None
    probe = calib_loop.get_unit_probe(model, walker, stackdefs, is_dec,
                                      bparams, x_q[:1], b1, m1)
    wpaths = [p for p in map(uncanon, probe.wpaths) if p in qstates]

    c_of = {p: canon(p) for p in wpaths}
    cfgs = {c_of[p]: qstates[p][1] for p in wpaths}
    states_c = {c_of[p]: qstates[p][0] for p in wpaths}
    bs = min(rc.calib_bs, N)

    if not wpaths:  # nothing to optimize: only the forward programs run
        misses0 = calib_loop.cache_stats()["unit_misses"]
        progs = calib_loop.get_unit_programs(
            model, walker, stackdefs, is_dec, {}, rc, bs, N,
            bparams, {}, {"v": {}, "s": {}}, (x_q, x_fp, None, calib, mem_q))
        cache_hit = calib_loop.cache_stats()["unit_misses"] == misses0
        z_fp = progs.fwd(bparams, x_fp, calib, mem_fp)
        x_q2 = progs.fwd(bparams, x_q, calib, mem_q)
        return z_fp, x_q2, {}, {}, {"unit": list(unit), "skipped": True,
                                    "cache_hit": cache_hit,
                                    "wall_s": time.time() - t0}

    # diagonal Fisher at the unit's output block, computed on demand
    g2 = fisher.for_block(max(unit)) if fisher is not None else None

    v0 = {c_of[p]: adaround.init_v(weights[p], *qstates[p]) for p in wpaths}
    s0 = {}
    act_of = {}
    if rc.a_bits is not None:
        for cp, a in probe.acts(bparams, x_q[:1], b1, m1).items():
            act_of[uncanon(cp)] = cp
            s0[cp] = lsq.init_act_scale(a, rc.a_bits, symmetric=True)
    opt0 = {"v": v0, "s": s0}  # the RTN start point, never updated in place

    misses0 = calib_loop.cache_stats()["unit_misses"]
    progs = calib_loop.get_unit_programs(
        model, walker, stackdefs, is_dec, cfgs, rc, bs, N,
        bparams, states_c, opt0, (x_q, x_fp, g2, calib, mem_q))
    cache_hit = calib_loop.cache_stats()["unit_misses"] == misses0

    z_fp = progs.fwd(bparams, x_fp, calib, mem_fp)

    def mse_vs_fp(x):
        return float(torch.mean((x - z_fp).to(torch.float32) ** 2))

    rtn_mse = None
    x_rtn = None
    if rc.unit_guard:
        # RTN baseline through the hard program: hard_quant at the initial
        # logits is exactly round-to-nearest
        x_rtn = progs.hard(bparams, states_c, opt0, x_q, calib, mem_q)
        rtn_mse = mse_vs_fp(x_rtn)

    opt_wall = 0.0
    retries = 0
    oom_halvings = 0
    fallback = False
    lr_scale = 1.0
    opt = losses = x_q2 = mse = None
    while True:
        opt_try = _clone(opt0)
        t_opt = time.time()
        try:
            opt_try, losses = calib_loop.run_unit_loop(
                progs, rc, bparams, states_c, opt_try, adam.init(opt_try),
                gen, x_q, x_fp, z_fp, g2, calib, mem_q, lr_scale=lr_scale)
        except torch.cuda.OutOfMemoryError:
            opt_wall += time.time() - t_opt
            if not rc.unit_guard or bs <= 1 or oom_halvings >= 3:
                raise
            # device OOM: halve the calibration minibatch
            oom_halvings += 1
            bs = max(1, bs // 2)
            progs = calib_loop.get_unit_programs(
                model, walker, stackdefs, is_dec, cfgs, rc, bs, N,
                bparams, states_c, opt0, (x_q, x_fp, g2, calib, mem_q))
            continue
        opt_wall += time.time() - t_opt
        opt = opt_try
        x_q2 = progs.hard(bparams, states_c, opt, x_q, calib, mem_q)
        mse = mse_vs_fp(x_q2)
        if not rc.unit_guard:
            break
        healthy = (bool(np.all(np.isfinite(losses))) and np.isfinite(mse)
                   and mse <= rtn_mse * rc.mse_guard_ratio)
        if healthy:
            break
        if retries >= rc.unit_retries:
            fallback = True
            break
        retries += 1
        lr_scale *= rc.retry_lr_decay

    if fallback:
        # degrade to the RTN baseline: omit this unit's logits so bake()
        # rounds to nearest; keep the initial act scales (x_rtn used them)
        x_q2, mse = x_rtn, rtn_mse
        v_real = {}
        s_real = {p: opt0["s"][c] for p, c in act_of.items()}
    else:
        v_real = {p: opt["v"][c_of[p]] for p in wpaths}
        s_real = {p: opt["s"][c] for p, c in act_of.items()}

    n_iters = rc.iters * (retries + 1)
    stat = {"unit": list(unit), "paths": len(wpaths), "iters": rc.iters,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "loss_trace": losses,
            "final_recon_mse": mse,
            "opt_iters": n_iters, "opt_wall_s": opt_wall,
            "calib_iters_per_s": n_iters / max(opt_wall, 1e-9),
            "cache_hit": cache_hit,
            "retries": retries, "fallback": fallback,
            "oom_halvings": oom_halvings, "calib_bs": bs,
            "wall_s": time.time() - t0}
    if rtn_mse is not None:
        stat["rtn_recon_mse"] = rtn_mse
    return z_fp, x_q2, v_real, s_real, stat


# ---------------------------------------------------------------------------
# layer-wise units (AdaRound baseline: per-linear MSE, no Fisher)
# ---------------------------------------------------------------------------


def _reconstruct_layerwise(model, walker, params, weights, calib, bi, x_fp, x_q,
                           mem_fp, mem_q, qstates, rc: ReconConfig, gen):
    """AdaRound-style: each linear reconstructs its own output z = x W,
    through the cached layer programs; the block's forward and hardened
    passes reuse the unit program cache."""
    t0 = time.time()
    unit = [bi]
    canon = _unit_canon(walker, unit)
    uncanon = _unit_uncanon(walker, unit)
    bparams, stackdefs, is_dec = _unit_pieces(walker, params, unit)
    N = calib["tokens"].shape[0]
    probe = calib_loop.get_unit_probe(
        model, walker, stackdefs, is_dec, bparams, x_q[:1],
        _slice_batch(calib, slice(0, 1)), mem_q[:1] if mem_q is not None else None)
    wpaths = [p for p in map(uncanon, probe.wpaths) if p in qstates]
    c_of = {p: canon(p) for p in wpaths}
    cfgs = {c_of[p]: qstates[p][1] for p in wpaths}
    states_c = {c_of[p]: qstates[p][0] for p in wpaths}
    s_paths = tuple(sorted(c_of.values())) if rc.a_bits is not None else ()
    # structure-only signature of the opt tree the hard pass will receive
    hard_opt_sig = {
        "v": {c_of[p]: weights[p] for p in wpaths},
        "s": {c: torch.zeros((), device=x_q.device) for c in s_paths}}

    misses0 = calib_loop.cache_stats()["unit_misses"]
    uprogs = calib_loop.get_unit_programs(
        model, walker, stackdefs, is_dec, cfgs, rc, min(rc.calib_bs, N), N,
        bparams, states_c, hard_opt_sig, (x_q, x_fp, None, calib, mem_q))
    cache_hit = calib_loop.cache_stats()["unit_misses"] == misses0

    z_fp = uprogs.fwd(bparams, x_fp, calib, mem_fp)

    v_done: dict[str, torch.Tensor] = {}
    s_done: dict[str, torch.Tensor] = {}
    opt_wall = 0.0
    for pi, path in enumerate(wpaths):
        W = weights[path]
        st, qc = qstates[path]
        # this linear's inputs on both streams, through the cached
        # canonical capture programs
        states_done = {c_of[p]: qstates[p][0] for p in v_done}
        cv_done = {c_of[p]: v for p, v in v_done.items()}
        cs_done = {c_of[p]: s for p, s in s_done.items()}
        cfg_items = tuple(sorted((c_of[p], qstates[p][1]) for p in v_done))
        data_q = (bparams, states_done, cv_done, cs_done, x_q, calib, mem_q)
        xin_q = calib_loop.get_capture_program(
            model, walker, stackdefs, is_dec, c_of[path], cfg_items,
            rc.a_bits, rc, data_q).run(*data_q)
        data_fp = (bparams, {}, {}, {}, x_fp, calib, mem_fp)
        xin_fp = calib_loop.get_capture_program(
            model, walker, stackdefs, is_dec, c_of[path], (), None,
            rc, data_fp).run(*data_fp)
        zt = torch.matmul(xin_fp.to(torch.float32),
                          W.to(torch.float32)).to(xin_fp.dtype)
        opt = {"v": {"w": adaround.init_v(W, st, qc)}, "s": {}}
        if rc.a_bits is not None:
            opt["s"]["w"] = lsq.init_act_scale(xin_q, rc.a_bits, symmetric=True)
        lead = xin_q.shape[0]
        bs = min(rc.calib_bs, lead)
        progs = calib_loop.get_layer_programs(qc, rc, bs, lead, W, st, opt,
                                              xin_q, zt)
        t_opt = time.time()
        opt, _losses = calib_loop.run_layer_loop(
            progs, rc, W, st, opt, adam.init(opt), gen, xin_q, zt)
        opt_wall += time.time() - t_opt
        v_done[path] = opt["v"]["w"]
        if rc.a_bits is not None:
            s_done[path] = opt["s"]["w"]

    hard_opt = {"v": {c_of[p]: v for p, v in v_done.items()},
                "s": {c_of[p]: s for p, s in s_done.items()}}
    x_q2 = uprogs.hard(bparams, states_c, hard_opt, x_q, calib, mem_q)
    n_iters = len(wpaths) * rc.iters
    stat = {"unit": [bi], "paths": len(wpaths), "iters": rc.iters,
            "final_recon_mse": float(torch.mean((x_q2 - z_fp).to(torch.float32) ** 2)),
            "opt_iters": n_iters, "opt_wall_s": opt_wall,
            "calib_iters_per_s": n_iters / max(opt_wall, 1e-9),
            "cache_hit": cache_hit,
            "wall_s": time.time() - t0}
    return z_fp, x_q2, v_done, s_done, stat


# ---------------------------------------------------------------------------
# baking
# ---------------------------------------------------------------------------


@torch.no_grad()
def bake(model, params, qstates, v_all, embed_head) -> Params:
    """Write hard-quantized weights back into a params copy (``params`` is
    not mutated: each leaf that changes is cloned once)."""
    params_q = tree_map(lambda x: x, params)
    cloned: set = set()

    def set_leaf(path: str, fn):
        parts = path.split("/")
        if "." in parts[0]:
            sname, ri = parts[0].rsplit(".", 1)
            node, keys = params_q[sname], parts[1:] + ["w"]
            idx = int(ri)
        else:
            node, keys, idx = params_q, parts, None
        for k in keys[:-1]:
            node = node[k]
        leaf = node[keys[-1]]
        if id(leaf) not in cloned:
            leaf = node[keys[-1]] = leaf.clone()
            cloned.add(id(leaf))
        if idx is None:
            leaf.copy_(fn(leaf))
        else:
            leaf[idx] = fn(leaf[idx])

    for path, (st, cfg) in qstates.items():
        if path in v_all:
            v = v_all[path]
            set_leaf(path, lambda w, v=v, st=st, cfg=cfg: adaround.hard_quant(w, v, st, cfg))
        else:
            set_leaf(path, lambda w, st=st, cfg=cfg: quantize_dequant(w, st, cfg))
    for path, (st, cfg) in embed_head.items():
        set_leaf(path, lambda w, st=st, cfg=cfg: quantize_dequant(w, st, cfg))
    return params_q


def rtn_on_scales(model, params, res: PTQResult, batch: dict) -> Params:
    """The RTN baseline on ``res``'s own scales: every block weight rounded
    to nearest on its calibrated scale (AdaRound's rounding logits at their
    RTN start, ``adaround.init_v``), the embedding and head as ``res``
    quantized them, baked into a copy of ``params``. Beside ``res.params_q``
    it isolates what the learned rounding buys. ``batch`` (its first
    sequence) walks the model to find the weights."""
    weights = enumerate_weights(model, params, {k: t[:1] for k, t in batch.items()})
    blocks = {p: s for p, s in res.qstates.items() if "." in p.split("/")[0]}
    embed = {p: s for p, s in res.qstates.items() if p not in blocks}
    v_rtn = {p: adaround.init_v(weights[p], *s) for p, s in blocks.items()}
    return bake(model, params, blocks, v_rtn, embed)
