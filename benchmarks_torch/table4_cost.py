"""Paper Table 4: PTQ-vs-QAT cost/accuracy trade.

The port's counterpart of ``benchmarks/table4_cost.py``. BRECQ calibrates
with N_CALIB sequences in seconds-to-minutes; a straight-through-estimator
QAT run needs the full training stream and many steps to match. We report
wall time, data budget and final loss for both at W4 (the paper's 240x
production-speed claim, at bench scale).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core import PTQResult, ReconConfig
from repro_torch.core.evaluate import evaluate
from repro_torch.core.hooks import RTNHook
from repro_torch.core.quantizer import fake_quant_ste
from repro_torch.core.reconstruction import Walker, bake, enumerate_weights, init_states
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.deploy import export
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.optim import adam

from .common import (BATCH, RECON_ITERS, SEQ, cached_brecq, device_arg, emit,
                     get_bench_model, params_device, synchronize)

QAT_STEPS = 150
W_BITS = 4


def qat_ste(model, params, cfg, steps: Optional[int] = None, lr=5e-4):
    """STE fake-quant QAT baseline (PACT/DSQ-class), trained on the full
    data stream (``steps`` defaults to ``QAT_STEPS``), on the params'
    device. The JAX package scans every step in one program; here the
    steps run eagerly, and the wall covers them between two syncs."""
    steps = QAT_STEPS if steps is None else steps
    dev = params_device(params)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    probe = {k: v.to(dev) for k, v in make_batches(corpus, 1, 1, 8, seed=9)[0].items()}
    rc = ReconConfig(w_bits=W_BITS)
    weights = enumerate_weights(model, params, probe)
    qstates, embed_head = init_states(model, weights, rc)
    walker = Walker(model)

    class QATHook(RTNHook):
        def weight(self, path, w):
            if path in qstates:
                return fake_quant_ste(w, *qstates[path])
            if path in embed_head:
                return fake_quant_ste(w, *embed_head[path])
            return w

    hook = QATHook({})
    acfg = adam.AdamConfig(lr=lr, grad_clip=1.0)
    state = adam.init(params)
    # the training stream on the device before the clock starts, as the
    # JAX package pregenerates it
    toks = [make_batches(corpus, 1, BATCH, SEQ, seed=3, start_step=i)[0]["tokens"].to(dev)
            for i in range(steps)]

    synchronize(dev)
    t0 = time.time()
    for t in toks:
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(tree)
        loss = walker.loss(tree, {"tokens": t}, hook)
        by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            params, state = adam.update(acfg, tree_map(lambda p: by_leaf[id(p)], tree),
                                        state, params)
    synchronize(dev)
    wall = time.time() - t0
    tokens_seen = steps * BATCH * SEQ
    # evaluate with hardened RTN weights at the fine-tuned point
    weights2 = enumerate_weights(model, params, probe)
    qstates2, embed_head2 = init_states(model, weights2, rc)
    params_q = bake(model, params, qstates2, {}, embed_head2)
    return params_q, wall, tokens_seen


def main(device=None) -> list[dict]:
    cfg, model, params, calib, evalb = get_bench_model(device=device)
    fp = evaluate(model, params, evalb)
    rows = [{"name": "fp32", "us_per_call": 0,
             "derived": f"loss={fp['loss']:.4f}"}]

    res = cached_brecq(model, params, calib,
                       ReconConfig(w_bits=W_BITS, iters=RECON_ITERS),
                       f"t2_brecq_w{W_BITS}")
    ev = evaluate(model, res["params_q"], evalb)
    calib_tokens = sum(int(b["tokens"].numel()) for b in calib)
    brecq_wall = res["stats"]["calib_wall_s"]
    peak_mb = res["stats"]["calib_peak_bytes"] / 1e6
    fisher_s = res["stats"]["fisher_wall_s"]
    retries = res["stats"]["unit_retries"]
    fallbacks = res["stats"]["unit_fallbacks"]
    stragglers = res["stats"]["stragglers"]
    rows.append({"name": f"brecq_w{W_BITS}", "us_per_call": brecq_wall * 1e6,
                 "derived": (f"loss={ev['loss']:.4f};wall_s={brecq_wall:.0f};"
                             f"fisher_wall_s={fisher_s:.0f};"
                             f"peak_mb={peak_mb:.1f};"
                             f"data_tokens={calib_tokens};"
                             f"retries={retries};fallbacks={fallbacks};"
                             f"stragglers={stragglers}")})

    # production cost includes packing the deployment artifact
    art = export(model, PTQResult(
        params_q=res["params_q"], act_scales=res["act_scales"],
        qstates=res["qstates"], v=res["v"], stats=res["stats"]))
    rows.append({"name": f"deploy_w{W_BITS}",
                 "us_per_call": art.stats["pack_wall_s"] * 1e6,
                 "derived": (f"pack_wall_s={art.stats['pack_wall_s']:.2f};"
                             f"artifact_mb={art.stats['artifact_bytes']/1e6:.2f};"
                             f"fp_mb={art.stats['fp_bytes']/1e6:.2f};"
                             f"bits_hist={art.stats['bits_histogram']}")})

    pq, wall, tokens = qat_ste(model, params, cfg)
    evq = evaluate(model, pq, evalb)
    rows.append({"name": f"qat_ste_w{W_BITS}", "us_per_call": wall * 1e6,
                 "derived": (f"loss={evq['loss']:.4f};wall_s={wall:.0f};"
                             f"data_tokens={tokens}")})
    if brecq_wall > 0:
        rows.append({"name": "speedup", "us_per_call": 0,
                     "derived": f"qat_wall/brecq_wall={wall / brecq_wall:.1f}x;"
                                f"data_ratio={tokens / calib_tokens:.1f}x"})
    emit(rows, "table4")
    return rows


if __name__ == "__main__":
    main(device_arg())
