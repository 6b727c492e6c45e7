"""Batched serving entry point: prefill + greedy decode from a packed artifact.

The port of the JAX package's ``repro.launch.serve``:
  1. resolve weights — FP params, a saved :class:`QuantizedArtifact`
     (``--artifact DIR``), a fresh RTN artifact (``--quant BITS``), or a
     mixed-precision one solved under a budget (``--budget-bytes`` /
     ``--budget-decode-ms``, ``deploy.budget``); fresh artifacts are saved
     and re-loaded with verification so the served bytes are exactly
     what a deployment would ship,
  2. prefill the prompt batch, 3. decode N tokens greedily,
  4. report artifact bytes vs FP, tokens/s and which qmm tiers fired.

The fixed batch of a VLM carries its ``patches``, of an encoder-decoder
model its ``frames`` (:func:`fixed_batch`). ``--engine`` serves synthetic
streams with staggered arrivals through the continuous-batching engine
(``repro_torch.serve_engine``) over a paged KV pool instead; ``--batch`` is
then the slot count. The engine takes attention-only models: a
cross-attention or recurrent layer (xLSTM, hymba) raises, as in the JAX
package; those families serve through the fixed batch.

Packed weights stay int codes on the device end to end: every linear runs
through ``QuantHook.packed_matmul`` -> ``qmm``, which launches the CUDA
``qgemv`` (decode) and ``qmatmul`` (prefill) kernels for CUDA tensors; the
engine's int8 pool is read by the CUDA ``kv_decode`` kernel.

Runs on the GPU by default; ``--device cpu`` runs the plain PyTorch path
on the host. Usage:

    PYTHONPATH=src python -m repro_torch.launch.serve --quant 4
    PYTHONPATH=src python -m repro_torch.launch.serve --quant 4 --engine
    PYTHONPATH=src python -m repro_torch.launch.serve --budget-bytes 3e7

``--dispatch measured`` times each decode-shaped layer's tiers (K1 and K2
on the card, replayed from a CUDA graph between CUDA events) and routes
by the winners.
"""
from __future__ import annotations

import argparse
import copy
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..data import Corpus, CorpusConfig
from ..deploy import (ArtifactMismatchError, QuantizedArtifact, rtn_artifact,
                      tree_bytes)
from ..device import resolve
from ..interop import tree_leaves, tree_map
from ..kernels.qmatmul import kernel as qmm_kernel
from ..kernels.qmatmul import ops as qmm_ops
from ..models import get_model
from ..models.common import NO_QUANT


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="brecq_lm_100m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--quant", type=int, default=None, choices=[2, 4, 8],
                   help="pack weights to this many bits (RTN artifact)")
    p.add_argument("--group", type=int, default=None)
    p.add_argument("--budget-bytes", type=float, default=None,
                   help="solve per-layer bits so the whole artifact fits "
                        "this many bytes, then serve it "
                        "(repro_torch.deploy.budget)")
    p.add_argument("--budget-decode-ms", type=float, default=None,
                   help="solve per-layer bits so the summed measured "
                        "per-layer decode matmul time fits this many ms, "
                        "then serve it")
    p.add_argument("--sens", default=None,
                   help="SensTable JSON (core.sensitivity.SensTable.save) "
                        "for --budget-*; default: calibration-free RTN "
                        "weight-error proxy")
    p.add_argument("--dispatch", default="auto",
                   choices=["auto", "heuristic", "measured"],
                   help="qmm decode-shape tier dispatch: measured times "
                        "each eligible tier at the served shapes (cached "
                        "in the artifact manifest per backend) and routes "
                        "by the winners; heuristic keeps the M<=8 gemv "
                        "guess; auto = measured iff a table is installed")
    p.add_argument("--artifact", default=None,
                   help="serve from a saved QuantizedArtifact directory")
    p.add_argument("--save-artifact", default=None,
                   help="where --quant/--budget-* save the artifact "
                        "(default: tmpdir)")
    p.add_argument("--no-compare-fp", action="store_true",
                   help="skip the FP throughput reference pass")
    p.add_argument("--packed-backend", default="auto",
                   choices=list(qmm_ops.BACKENDS),
                   help="qmm execution path for packed weights: the CUDA "
                        "kernels, the plain PyTorch version, or auto (by "
                        "the tensors' device); tiers are still picked by "
                        "shape")
    p.add_argument("--no-verify", action="store_true",
                   help="skip artifact schema/checksum verification at load")
    p.add_argument("--engine", action="store_true",
                   help="serve through the continuous-batching engine "
                        "(repro_torch.serve_engine) instead of the fixed-batch "
                        "harness; --batch becomes the slot count")
    p.add_argument("--streams", type=int, default=None,
                   help="number of synthetic request streams for --engine "
                        "(staggered arrivals, mixed lengths; default: "
                        "2x the slot count)")
    p.add_argument("--kv-dtype", default=None,
                   choices=["int8", "float16", "bfloat16", "float32"],
                   help="engine KV pool dtype (default: artifact manifest "
                        "kv_dtype, else int8)")
    p.add_argument("--page-size", type=int, default=None,
                   help="engine KV page size in tokens (default: manifest "
                        "kv_page_size, else 16)")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   help="engine prefill chunk length (tokens per tick)")
    p.add_argument("--num-pages", type=int, default=None,
                   help="engine KV pool size in pages incl. the sink "
                        "(default: worst-case sizing — every slot can hold "
                        "a full-length stream); set it below that to create "
                        "page pressure")
    p.add_argument("--overcommit", default="none",
                   choices=["none", "prompt"],
                   help="engine admission policy: 'none' reserves the "
                        "worst-case page need up front (reference); "
                        "'prompt' reserves only the prompt's pages plus a "
                        "small headroom and preempts the newest / lowest-"
                        "priority stream on pool exhaustion (bit-exact "
                        "re-prefill resume)")
    p.add_argument("--deadline-ticks", type=int, default=None,
                   help="per-request relative deadline for --engine: a "
                        "stream not finished within this many ticks of "
                        "submission moves to the terminal 'expired' state "
                        "and its pages are reclaimed")
    p.add_argument("--drain-on-sigterm", action="store_true",
                   help="install GracefulShutdown for the --engine loop: "
                        "SIGTERM/SIGINT stops admission, finishes in-flight "
                        "streams and reports per-request statuses instead "
                        "of killing them dead")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    return p.parse_args(argv)


def _check_manifest(manifest: dict, cfg) -> None:
    """Fail fast when a loaded artifact doesn't match the model built
    from --arch/--reduced."""
    for field, got in (("arch", cfg.name), ("n_layers", cfg.n_layers),
                       ("d_model", cfg.d_model), ("vocab", cfg.vocab)):
        want = manifest.get(field)
        if want is not None and want != got:
            raise ArtifactMismatchError(
                f"artifact was exported for {field}={want!r} but the served "
                f"model has {field}={got!r} — pass the matching --arch/"
                f"--reduced flags (manifest: arch={manifest.get('arch')!r}, "
                f"n_layers={manifest.get('n_layers')}, "
                f"d_model={manifest.get('d_model')}, "
                f"vocab={manifest.get('vocab')})")


def _solve_budget_artifact(args, cfg, params):
    """--budget-bytes/--budget-decode-ms: sensitivity table (measured
    JSON via --sens, else the RTN weight-error proxy) -> exact solver ->
    packed mixed-precision artifact, on the params' device (a decode-ms
    table is timed there). Raises on an infeasible budget."""
    from ..core.sensitivity import SensTable
    from ..deploy.budget import budget_artifact, weight_sens_table

    if args.budget_bytes is not None and args.budget_decode_ms is not None:
        raise SystemExit("pass --budget-bytes or --budget-decode-ms, not both")
    if args.sens:
        sens = SensTable.load(args.sens)
    else:
        sens = weight_sens_table(params, cfg.n_layers, group=args.group)
    if args.budget_bytes is not None:
        kind, budget = "bytes", args.budget_bytes
    else:
        kind, budget = "decode_ms", args.budget_decode_ms
    art, sol, _ = budget_artifact(params, sens, budget, kind=kind, cfg=cfg,
                                  group=args.group,
                                  m=min(args.batch, 8) if kind != "bytes" else 1)
    if kind == "bytes" and art.nbytes() > budget:
        raise ArtifactMismatchError(
            f"budget solve produced a {art.nbytes()}-byte artifact over the "
            f"{budget:g}-byte budget")
    return art


def _setup_dispatch(args, cfg, params, artifact, device) -> None:
    """--dispatch: route decode-shaped qmm calls by measured tier
    winners. 'measured' times the served shapes now on ``device`` (the
    CUDA kernels on the card), reusing the artifact's per-backend
    manifest cache when present; 'heuristic' pins the env override so
    even an installed table is ignored."""
    import os

    if args.dispatch == "heuristic":
        os.environ["REPRO_QMM_DISPATCH"] = "heuristic"
        return
    if args.dispatch != "measured":
        return
    if artifact is None:
        raise SystemExit("--dispatch measured needs packed weights "
                         "(--artifact/--quant/--budget-*)")
    from ..deploy.budget import (ensure_cost_table, install_dispatch,
                                 weight_shapes)

    os.environ["REPRO_QMM_DISPATCH"] = "measured"
    table = ensure_cost_table(artifact, weight_shapes(params, cfg.n_layers),
                              m=min(args.batch, 8), device=device)
    install_dispatch(table)
    wins: dict = {}
    for tier in table.dispatch.values():
        wins[tier] = wins.get(tier, 0) + 1
    print(f"[dispatch] measured tier winners on {table.backend} "
          f"({table.meta.get('device_name')}, m={table.meta['m']}): {wins} "
          f"over {table.meta['unique_shapes']} shapes")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_prefill_decode(model, params, batch, *, batch_size: int,
                       prompt_len: int, gen_len: int, hook=None, tag="fp",
                       quiet=False):
    """One prefill + ``gen_len`` greedy decode steps; returns (gen tokens
    (B, gen_len), stats).

    ``t_compile`` covers loading the kernel library (building it on first
    use) and one warm-up prefill and decode step on a scratch cache, so
    ``t_prefill``/``t_decode`` are steady-state walls. ``qmm_tiers``
    counts the tiers the warm-up prefill and decode step dispatched to
    (the JAX package counts them once per traced program).
    """
    hook = hook or NO_QUANT
    tokens = batch["tokens"]
    device = tokens.device

    def new_cache():
        return model.init_cache(batch_size, prompt_len + gen_len,
                                torch.float32, device)

    packed_cuda = (device.type == "cuda"
                   and any(t.dtype == torch.int8 for t in tree_leaves(params))
                   and hook.packed_backend != "torch")
    tiers0 = dict(qmm_ops.TIER_COUNTS)
    t0 = time.perf_counter()
    if packed_cuda:
        qmm_kernel.load_library()
    logits, warm = model.prefill(params, batch, new_cache(), hook)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    pos0 = torch.full((batch_size,), prompt_len, dtype=torch.int32, device=device)
    model.decode_step(params, tok, warm, pos0, hook)
    _sync(device)
    t_compile = time.perf_counter() - t0
    tiers = {k: qmm_ops.TIER_COUNTS[k] - tiers0[k] for k in tiers0}
    del warm

    cache = new_cache()
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache, hook)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        pos = torch.full((batch_size,), prompt_len + i, dtype=torch.int32,
                         device=device)
        logits, cache = model.decode_step(params, tok, cache, pos, hook)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    toks = batch_size * (gen_len - 1)
    tok_s = toks / max(t_decode, 1e-9)
    prefill_tok_s = batch_size * prompt_len / max(t_prefill, 1e-9)
    if not quiet:
        used = ",".join(f"{k}={v}" for k, v in tiers.items() if v) or "none"
        note = "" if qmm_ops.decode_tier_enabled() else " (decode tier off)"
        print(f"[{tag}] compile {t_compile:.2f}s; prefill {batch_size}x"
              f"{prompt_len} in {t_prefill:.4f}s ({prefill_tok_s:.0f} tok/s); "
              f"decode {toks} tokens in {t_decode:.4f}s ({tok_s:.1f} tok/s); "
              f"qmm tiers: {used}{note}")
    gen = torch.cat(out_tokens, dim=1)
    return gen, {"t_prefill": t_prefill, "t_decode": t_decode,
                 "t_compile": t_compile, "tok_s": tok_s,
                 "prefill_tok_s": prefill_tok_s, "qmm_tiers": tiers,
                 "decode_tier_enabled": qmm_ops.decode_tier_enabled()}


def _run_once(model, params, batch, args, hook=None, tag="fp"):
    return run_prefill_decode(model, params, batch, batch_size=args.batch,
                              prompt_len=args.prompt_len,
                              gen_len=args.gen_len, hook=hook, tag=tag)


def main(argv=None, params=None):
    """Serve once; returns a dict with the generated ``tokens`` (B,
    gen_len), the packed run's ``stats`` (the FP run's when no artifact),
    ``fp_stats`` when the FP pass ran, and ``artifact_bytes``/``fp_bytes``.
    With ``--engine``: the engine's ``metrics``, ``tokens`` as ``{uid:
    [generated ids]}`` and the requests' final ``states``.

    ``params`` (optional) are FP weights to serve instead of random ones
    drawn from ``--seed``; they are moved to the serving device.
    """
    args = parse_args(argv)
    device = resolve(args.device)
    cfg, model = get_model(args.arch, reduced=args.reduced)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init(gen)
    else:
        params = tree_map(lambda t: t.to(device), params)
    fp_bytes = tree_bytes(params)

    artifact = None
    tmp_dir = None  # cleaned on exit when the user didn't ask to keep it
    try:
        if args.artifact:
            artifact = QuantizedArtifact.load(args.artifact,
                                              verify=not args.no_verify)
            _check_manifest(artifact.manifest, cfg)
            print(f"loaded artifact {args.artifact}: "
                  f"{artifact.nbytes()/1e6:.1f}MB, manifest arch="
                  f"{artifact.manifest.get('arch')}")
        elif args.budget_bytes is not None or args.budget_decode_ms is not None:
            art = _solve_budget_artifact(args, cfg, params)
            if args.save_artifact:
                out_dir = args.save_artifact
            else:
                tmp_dir = tempfile.TemporaryDirectory(prefix="brecq_art_")
                out_dir = tmp_dir.name
            art.save(out_dir)
            # serve what was shipped, through the same verifying loader
            artifact = QuantizedArtifact.load(out_dir,
                                              verify=not args.no_verify)
            info = artifact.manifest["budget"]
            print(f"[budget] {info['kind']} <= {info['budget']:g}: solved "
                  f"bits {info['bits_histogram']} predicted-loss "
                  f"{info['predicted_loss']:.4g}; artifact_bytes="
                  f"{artifact.nbytes()} -> {out_dir}")
        elif args.quant is not None:
            art = rtn_artifact(params, args.quant, args.group, cfg=cfg)
            if args.save_artifact:
                out_dir = args.save_artifact
            else:
                tmp_dir = tempfile.TemporaryDirectory(prefix="brecq_art_")
                out_dir = tmp_dir.name
            art.save(out_dir)
            # serve what was shipped, through the same verifying loader
            artifact = QuantizedArtifact.load(out_dir,
                                              verify=not args.no_verify)
            print(f"packed W{args.quant} artifact in "
                  f"{art.stats['pack_wall_s']:.2f}s -> {out_dir}")
        if artifact is not None:
            artifact = artifact.to(device)
        _setup_dispatch(args, cfg, params, artifact, device)
        return _serve(args, cfg, model, params, artifact, fp_bytes, device)
    finally:
        if tmp_dir is not None:
            tmp_dir.cleanup()


def engine_config(args, manifest: dict, **over):
    """The :class:`EngineConfig` that ``--engine`` serves with: the KV
    dtype and page size from the flags, else the artifact's manifest;
    ``--batch`` slots; the pool sized for the worst case unless
    ``--num-pages`` says otherwise. ``over`` replaces fields."""
    from ..serve_engine import EngineConfig

    page_size = args.page_size or int(manifest.get("kv_page_size") or 16)
    max_len = args.prompt_len + args.gen_len
    pages_per = -(-max_len // page_size)
    fields = dict(
        num_slots=args.batch, page_size=page_size,
        num_pages=args.num_pages or 1 + args.batch * pages_per,
        max_len=max_len,
        prefill_chunk=min(args.prefill_chunk, max(args.prompt_len, 1)),
        kv_dtype=args.kv_dtype or manifest.get("kv_dtype") or "int8",
        overcommit=args.overcommit)
    fields.update(over)
    return EngineConfig(**fields)


def engine_streams(args, vocab: int) -> list:
    """The synthetic streams of ``--engine``, from ``--seed``: ``--streams``
    (default 2x the slots) of ``(arrival tick, prompt, max_new)``, sorted
    by arrival, with prompts of prompt-len/2..prompt-len tokens and
    generations of gen-len/2..gen-len (the JAX CLI's draws)."""
    streams = args.streams or 2 * args.batch
    rng = np.random.default_rng(args.seed)
    corpus = Corpus(CorpusConfig(vocab=vocab))
    arrivals = sorted(int(a) for a in rng.integers(0, 4 * streams, streams))
    plens = rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1,
                         streams)
    gens = rng.integers(max(args.gen_len // 2, 1), args.gen_len + 1, streams)
    return [(arrivals[i], corpus.sample(1, int(plens[i]), seed=args.seed + i)[0],
             int(gens[i])) for i in range(streams)]


def drive_engine(eng, streams: list, *, deadline_ticks: Optional[int] = None,
                 shutdown=None) -> None:
    """Submit each stream on its arrival tick and tick until all are
    served; with ``shutdown`` (a ``GracefulShutdown``), drain once it is
    requested."""
    nxt = 0
    while nxt < len(streams) or eng.pending():
        if shutdown is not None and shutdown.requested:
            statuses = eng.drain(finish=True)
            counts: dict = {}
            for st in statuses.values():
                counts[st] = counts.get(st, 0) + 1
            print(f"[drain] signal received: admission stopped, "
                  f"in-flight work settled; request statuses {counts} "
                  f"({len(streams) - nxt} never submitted)")
            break
        while nxt < len(streams) and streams[nxt][0] <= eng.tick:
            eng.submit(streams[nxt][1], streams[nxt][2],
                       deadline_ticks=deadline_ticks)
            nxt += 1
        eng.step()


def _serve_engine(args, cfg, model, params, artifact):
    """Continuous-batching mode: synthetic streams with staggered
    arrivals and mixed prompt/gen lengths through the serve engine."""
    from ..serve_engine import ServeEngine
    from .watchdog import GracefulShutdown

    ecfg = engine_config(args, artifact.manifest if artifact is not None else {})
    hook = artifact.hook() if artifact is not None else NO_QUANT
    if args.packed_backend != "auto":
        hook = copy.copy(hook)  # NO_QUANT is a shared singleton
        hook.packed_backend = args.packed_backend
    weights = artifact.params if artifact is not None else params
    eng = ServeEngine(model, weights, ecfg, quant=hook)
    t_compile = eng.compile()
    streams = engine_streams(args, cfg.vocab)
    gs = GracefulShutdown() if args.drain_on_sigterm else None
    try:
        drive_engine(eng, streams, deadline_ticks=args.deadline_ticks, shutdown=gs)
    finally:
        if gs is not None:
            gs.restore()
    eng.assert_no_leaks()
    m = eng.metrics()
    pressure = (f"; preempt {m['preemptions']} expired {m['expired']} "
                f"failed {m['failed']} stragglers {m['stragglers']}"
                if (m["preemptions"] or m["expired"] or m["failed"]
                    or m["stragglers"]) else "")
    print(f"[engine {ecfg.kv_dtype}] compile {t_compile:.2f}s; {len(streams)} "
          f"streams over {ecfg.num_slots} slots ({ecfg.num_pages} pages, "
          f"overcommit={ecfg.overcommit}): {m['tokens_generated']} tokens in "
          f"{m['wall_s']:.2f}s ({m['sustained_tok_s']:.1f} tok/s sustained); "
          f"occupancy {m['mean_slot_occupancy']:.2f}; resident KV "
          f"{m['mean_resident_kv_bytes_per_stream']/1e3:.1f}KB/stream "
          f"(page {ecfg.page_size} tok, {m['bytes_per_page']/1e3:.1f}KB)"
          f"{pressure}")
    return {"metrics": m,
            "tokens": {u: list(r.generated) for u, r in eng.requests.items()},
            "states": {u: r.state for u, r in eng.requests.items()}}


def fixed_batch(args, cfg) -> dict:
    """The fixed batch's CPU tensors: ``--batch`` prompts of
    ``--prompt-len`` tokens from the corpus (seed 7), with a VLM's
    ``patches`` (``n_patches`` a sequence) or an encoder-decoder model's
    ``frames`` (``--prompt-len`` a sequence), f32 normals from numpy's
    ``default_rng(0)``: the JAX CLI's draws."""
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    batch = {"tokens": torch.from_numpy(corpus.sample(args.batch, args.prompt_len,
                                                      seed=7))}
    if cfg.family == "vlm":
        rng = np.random.default_rng(0)
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(args.batch, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        rng = np.random.default_rng(0)
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(args.batch, args.prompt_len, cfg.d_model)).astype(np.float32))
    return batch


def _serve(args, cfg, model, params, artifact, fp_bytes, device):
    if args.engine:
        if artifact is not None:
            print(f"weights resident as packed int codes: {fp_bytes/1e6:.1f}MB "
                  f"fp32 -> {artifact.nbytes()/1e6:.1f}MB packed")
        out = _serve_engine(args, cfg, model, params, artifact)
        out["fp_bytes"] = fp_bytes
        if artifact is not None:
            out["artifact_bytes"] = artifact.nbytes()
        return out
    batch = {k: t.to(device) for k, t in fixed_batch(args, cfg).items()}

    if artifact is None:
        gen, stats = _run_once(model, params, batch, args, tag="fp")
        print("sample:", gen[0][:16].cpu().numpy())
        return {"tokens": gen, "stats": stats, "fp_bytes": fp_bytes}

    art_bytes = artifact.nbytes()
    print(f"weights resident as packed int codes: {fp_bytes/1e6:.1f}MB fp32 -> "
          f"{art_bytes/1e6:.1f}MB packed ({art_bytes/fp_bytes:.3f}x)")
    if art_bytes >= fp_bytes:
        raise ArtifactMismatchError(
            f"packed artifact ({art_bytes} bytes) is not smaller than the FP "
            f"model ({fp_bytes} bytes) — the artifact does not belong to "
            f"this model or holds unpacked weights")

    hook = artifact.hook()
    if args.packed_backend != "auto":
        hook = copy.copy(hook)  # NO_QUANT is a shared singleton
        hook.packed_backend = args.packed_backend
    gen, qstat = _run_once(model, artifact.params, batch, args,
                           hook=hook, tag="packed")
    out = {"tokens": gen, "stats": qstat, "artifact_bytes": art_bytes,
           "fp_bytes": fp_bytes}
    if not args.no_compare_fp:
        _, fstat = _run_once(model, params, batch, args, tag="fp")
        out["fp_stats"] = fstat
        print(f"packed vs fp: {qstat['tok_s']:.1f} vs {fstat['tok_s']:.1f} tok/s "
              f"decode; bytes {art_bytes/1e6:.1f}MB vs {fp_bytes/1e6:.1f}MB")
    print("sample:", np.asarray(gen[0][:16].cpu()))
    return out


if __name__ == "__main__":
    main()
