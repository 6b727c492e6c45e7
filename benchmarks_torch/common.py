"""Shared benchmark substrate: one trained bench model + cached PTQ runs.

The port's counterpart of ``benchmarks/common.py``: the same bench
configuration, training stream, calibration and eval batches, trained and
calibrated through ``repro_torch`` on the card unless ``--device cpu``
(or a ``device=`` argument) says otherwise. Everything is cached under
``artifacts/bench_torch/`` so tables compose; each cached file names the
device type it was made on (``bench_params.cuda.pt``), and loads back
onto that device, so results of the card and of the host never mix.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import ReconConfig, quantize
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.device import resolve
from repro_torch.interop import tree_leaves
from repro_torch.launch.train import train_step
from repro_torch.optim import adam

ART = Path(__file__).resolve().parents[1] / "artifacts" / "bench_torch"

BENCH_ARCH = "brecq_lm_100m"
TRAIN_STEPS = 400
BATCH, SEQ = 16, 96
N_CALIB = 64  # sequences (paper: 1024 images; scaled to the bench budget)
RECON_ITERS = 80  # paper: 20k/block; scaled to the bench budget


def bench_config():
    import dataclasses

    from repro_torch.models import get_config

    cfg = get_config(BENCH_ARCH, reduced=False)
    # bench scale of the same family (full 100M is for examples/)
    return dataclasses.replace(cfg, n_layers=6, d_model=256, n_heads=8,
                               n_kv_heads=8, d_ff=704, vocab=2048)


def device_arg(argv=None) -> Optional[str]:
    """The value of ``--device`` in ``argv`` (default ``sys.argv``), else
    ``None`` (the card)."""
    argv = sys.argv[1:] if argv is None else argv
    return argv[argv.index("--device") + 1] if "--device" in argv else None


def params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


def synchronize(device: torch.device) -> None:
    """Wait for the card, so host-clock walls cover the work they time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cached(name: str, device: torch.device) -> Path:
    return ART / f"{name}.{device.type}.pt"


def get_bench_model(train_steps: Optional[int] = None, device=None):
    """(cfg, model, params, calib_batches, eval_batches) on ``device``;
    the trained params are cached on disk. ``train_steps`` defaults to
    ``TRAIN_STEPS``."""
    from repro_torch.models import build_model

    dev = resolve(device)
    cfg = bench_config()
    model = build_model(cfg)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    cache = _cached("bench_params", dev)
    if cache.exists():
        params = torch.load(cache, map_location=dev)
    else:
        steps = TRAIN_STEPS if train_steps is None else train_steps
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        acfg = adam.AdamConfig(lr=3e-3, grad_clip=1.0)
        state = adam.init(params)
        t0 = time.time()
        loss = None
        for i in range(steps):
            toks = make_batches(corpus, 1, BATCH, SEQ, seed=0, start_step=i)[0]["tokens"]
            params, state, loss = train_step(model, acfg, params, state,
                                             {"tokens": toks.to(dev)}, "none")
            if (i + 1) % 100 == 0:
                print(f"[bench-train] step {i + 1} loss {float(loss):.3f}")
        synchronize(dev)
        final = "n/a" if loss is None else f"{float(loss):.3f}"
        print(f"[bench-train] {steps} steps in {time.time() - t0:.0f}s, "
              f"final loss {final}")
        ART.mkdir(parents=True, exist_ok=True)
        torch.save(params, cache)
    on_dev = lambda bs: [{k: v.to(dev) for k, v in b.items()} for b in bs]  # noqa: E731
    calib = on_dev(make_batches(corpus, N_CALIB // 8, 8, SEQ, seed=1, start_step=10_000))
    evalb = on_dev(make_batches(corpus, 4, 16, SEQ, seed=2, start_step=20_000))
    return cfg, model, params, calib, evalb


def cached_brecq(model, params, calib, rc: ReconConfig, tag: str):
    """BRECQ result cache keyed by tag (fig2 reuses table runs), on the
    params' device.

    Wall time comes from ``quantize()`` itself (stats['calib_wall_s']),
    so a cache-miss run can never report 0."""
    dev = params_device(params)
    f = _cached(f"brecq_{tag}", dev)
    if f.exists():
        return torch.load(f, map_location=dev, weights_only=False)
    res = quantize(model, params, calib, rc)
    out = {"params_q": res.params_q, "act_scales": res.act_scales,
           "v": res.v, "qstates": res.qstates, "stats": res.stats}
    ART.mkdir(parents=True, exist_ok=True)
    torch.save(out, f)
    return out


def emit(rows: list[dict], table: str):
    """Print the scaffold CSV (name,us_per_call,derived) + save JSON."""
    for r in rows:
        print(f"{table}/{r['name']},{r.get('us_per_call', 0):.0f},{r['derived']}")
    ART.mkdir(parents=True, exist_ok=True)
    (ART / f"{table}.json").write_text(json.dumps(rows, indent=1, default=float))
