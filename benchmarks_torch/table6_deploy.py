"""Table 6 (beyond paper): deployment cost of the packed-int artifact.

The port's counterpart of ``benchmarks/table6_deploy.py``. Four views of
the ``repro_torch.deploy`` path:
  * serve benchmark: prefill + decode tok/s on the serve config, FP vs
    packed W4, with the decode tier both on (``qgemv`` dispatch) and forced
    off (decode rows through the prefill GEMM ``qmatmul``), so the decode
    tier's win is recorded per run. Written to
    ``artifacts/bench_torch/BENCH_serve.json`` (``--out`` to override),
    never to the JAX package's tracked ``BENCH_serve.json``,
  * pack sweep: wall time + artifact bytes vs ``w_bits`` / ``w_group``
    (RTN fast path; packing cost is calibration-independent),
  * BRECQ export: pack time/bytes for the calibrated W4 result and the
    packed-vs-baked eval parity (should be ~0: same hard rounding),
  * serving throughput: prefill wall + decode tokens/s on the bench
    model, FP params vs the packed W4 artifact.

Runs on the card unless ``--device cpu``. ``python -m
benchmarks_torch.table6_deploy --serve-only`` runs just the first view (no
trained bench cache needed).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import PTQResult, ReconConfig
from repro_torch.core.evaluate import evaluate
from repro_torch.deploy import export, rtn_artifact, tree_bytes
from repro_torch.device import resolve
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.launch.serve import run_prefill_decode

from . import common
from .common import (RECON_ITERS, cached_brecq, device_name, emit, get_bench_model,
                     params_device)

W_BITS_SWEEP = (2, 4, 8)
GROUPS = (None, 64)
BATCH, PROMPT, GEN = 8, 64, 16

# the serve config (the reference's CI serve-smoke flags)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "brecq_lm_100m", 8, 64, 32


def serve_json() -> Path:
    return common.ART / "BENCH_serve.json"


def _throughput(model, params, hook=None, *, batch=BATCH, prompt=PROMPT,
                gen=GEN, vocab=None):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab or model.cfg.vocab, (batch, prompt)).astype(np.int32)
    toks = torch.from_numpy(toks).to(params_device(params))
    _, stat = run_prefill_decode(model, params, {"tokens": toks},
                                 batch_size=batch, prompt_len=prompt,
                                 gen_len=gen, hook=hook, quiet=True)
    return stat


def serve_bench(reduced: bool = True, device=None, out=None) -> dict:
    """fp-vs-packed decode/prefill tok/s on the serve config.

    Three passes, each the best of 2 reps: FP params, packed W4 through the
    shape dispatcher (decode steps hit the ``qgemv`` tier), and packed W4
    with the decode tier off (``set_decode_tier(False)``: decode rows
    through the prefill GEMM), kept as the before/after baseline; the
    tier's earlier state is restored afterwards.

    ``reduced`` (default, as the reference) serves the reduced config;
    ``reduced=False`` serves brecq-lm-100m at full width and depth, the one
    departure from the reference. Params from seed 0 on ``device``.
    """
    from repro_torch.models import get_model

    dev = resolve(device)
    cfg, model = get_model(SERVE_ARCH, reduced=reduced)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    art = rtn_artifact(params, 4, None, cfg=cfg)
    kw = dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
              vocab=cfg.vocab)

    def best_of(fn, reps=2):  # best decode wall of N reps (hosts are noisy)
        runs = [fn() for _ in range(reps)]
        return max(runs, key=lambda s: s["tok_s"])

    fp = best_of(lambda: _throughput(model, params, **kw))
    packed = best_of(lambda: _throughput(model, art.params, art.hook(), **kw))
    forced = qmm_ops.set_decode_tier(False)  # decode shapes through the prefill GEMM
    try:
        legacy = best_of(lambda: _throughput(model, art.params, art.hook(), **kw))
    finally:
        qmm_ops.set_decode_tier(forced)

    def row(s):
        return {"decode_tok_s": round(s["tok_s"], 1),
                "prefill_tok_s": round(s["prefill_tok_s"], 1),
                "t_compile_s": round(s["t_compile"], 2),
                "qmm_tiers": s["qmm_tiers"]}

    doc = {
        "config": {"arch": SERVE_ARCH, "reduced": reduced, "batch": SERVE_BATCH,
                   "prompt_len": SERVE_PROMPT, "gen_len": SERVE_GEN,
                   "w_bits": 4, "backend": dev.type, "device_name": device_name(dev)},
        "fp": row(fp),
        "packed_w4": row(packed),
        "packed_w4_no_decode_tier": row(legacy),
        "decode_ratio_packed_vs_fp": round(
            packed["tok_s"] / max(fp["tok_s"], 1e-9), 3),
        "decode_ratio_tier_vs_legacy": round(
            packed["tok_s"] / max(legacy["tok_s"], 1e-9), 3),
    }
    path = Path(out) if out is not None else serve_json()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"serve bench -> {path}: packed {doc['packed_w4']['decode_tok_s']}"
          f" vs fp {doc['fp']['decode_tok_s']} tok/s decode "
          f"(x{doc['decode_ratio_packed_vs_fp']}), tiers "
          f"{doc['packed_w4']['qmm_tiers']}")
    return doc


def main(device=None) -> list[dict]:
    dev = resolve(device)
    serve = serve_bench(device=dev)
    rows = [{"name": "serve_reduced_fp", "us_per_call": 0,
             "derived": f"decode_tok_s={serve['fp']['decode_tok_s']}"},
            {"name": "serve_reduced_packed_w4", "us_per_call": 0,
             "derived": (f"decode_tok_s={serve['packed_w4']['decode_tok_s']};"
                         f"ratio_vs_fp={serve['decode_ratio_packed_vs_fp']};"
                         f"ratio_vs_legacy={serve['decode_ratio_tier_vs_legacy']}")}]

    cfg, model, params, calib, evalb = get_bench_model(device=dev)
    fp_bytes = tree_bytes(params)

    # pack sweep: bytes + wall vs bits/group (RTN path)
    for bits in W_BITS_SWEEP:
        for group in GROUPS:
            art = rtn_artifact(params, bits, group, cfg=cfg)
            s = art.stats
            rows.append({
                "name": f"pack_w{bits}_g{group or 'chan'}",
                "us_per_call": s["pack_wall_s"] * 1e6,
                "derived": (f"bytes={s['artifact_bytes']};"
                            f"ratio={s['artifact_bytes']/fp_bytes:.3f};"
                            f"pack_wall_s={s['pack_wall_s']:.2f}")})

    # BRECQ W4 export: exactness + deployment stats for the calibrated run
    res_d = cached_brecq(model, params, calib,
                         ReconConfig(w_bits=4, iters=RECON_ITERS), "t2_brecq_w4")
    res = PTQResult(params_q=res_d["params_q"], act_scales=res_d["act_scales"],
                    qstates=res_d["qstates"], v=res_d["v"], stats=res_d["stats"])
    art = export(model, res)
    baked = evaluate(model, res.params_q, evalb)
    packed = evaluate(model, art, evalb)
    rows.append({
        "name": "export_brecq_w4",
        "us_per_call": art.stats["pack_wall_s"] * 1e6,
        "derived": (f"bytes={art.stats['artifact_bytes']};"
                    f"ratio={art.stats['artifact_bytes']/fp_bytes:.3f};"
                    f"loss_packed={packed['loss']:.4f};"
                    f"loss_baked={baked['loss']:.4f};"
                    f"bits_hist={art.stats['bits_histogram']}")})

    # serving throughput fp vs packed on the bench model
    fstat = _throughput(model, params)
    qstat = _throughput(model, art.params, art.hook())
    rows.append({"name": "serve_fp", "us_per_call": fstat["t_prefill"] * 1e6,
                 "derived": (f"decode_tok_s={fstat['tok_s']:.1f};"
                             f"bytes={fp_bytes}")})
    rows.append({"name": "serve_packed_w4", "us_per_call": qstat["t_prefill"] * 1e6,
                 "derived": (f"decode_tok_s={qstat['tok_s']:.1f};"
                             f"bytes={art.stats['artifact_bytes']};"
                             f"tok_s_ratio={qstat['tok_s']/max(fstat['tok_s'],1e-9):.2f};"
                             f"tiers={qstat['qmm_tiers']}")})
    emit(rows, "table6")
    return rows


def cli(argv=None):
    """``python -m benchmarks_torch.table6_deploy [--serve-only] [--device
    D] [--out PATH]``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve-only", action="store_true",
                    help="run just the serve benchmark (no bench cache needed)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    ap.add_argument("--out", default=None,
                    help="serve benchmark JSON (default: "
                         "artifacts/bench_torch/BENCH_serve.json)")
    args = ap.parse_args(argv)
    if args.serve_only:
        return serve_bench(device=args.device, out=args.out)
    return main(args.device)


if __name__ == "__main__":
    cli()
