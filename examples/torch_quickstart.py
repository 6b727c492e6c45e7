"""Quickstart on the port: quantize a small LM with BRECQ on the GPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The PyTorch counterpart of ``examples/quickstart.py``: trains a tiny LM on
the synthetic corpus, then compares FP / RTN-W2 / BRECQ-W2 perplexity — the
paper's headline effect in miniature — and finally exports the calibrated
result to a packed-int :class:`QuantizedArtifact`, saves and loads it, and
evaluates the packed model (what serving ships: on the card its matmuls run
through the packed ``qmatmul`` kernels). Runs on the GPU; ``--device cpu``
runs the plain PyTorch path on the host.

Set QUICKSTART_SMOKE=1 for a reduced run (fewer train steps, fewer
calibration iterations), which keeps the README's advertised flow from
rotting without spending minutes. The port's smoke trains 150 steps and
calibrates 50 iterations a block (the JAX example's 40 and 25 leave the
model near its initialisation, where BRECQ-W2 and RTN-W2 tie within
noise), so that BRECQ-W2 below RTN-W2 still shows.
"""
import argparse
import os
import tempfile
import time

import torch

SMOKE = os.environ.get("QUICKSTART_SMOKE", "") not in ("", "0")
TRAIN_STEPS = 150 if SMOKE else 250
BRECQ_ITERS = 50 if SMOKE else 200
N_CALIB_BATCHES = 4 if SMOKE else 8

from repro_torch.core import ReconConfig, quantize  # noqa: E402
from repro_torch.core.baselines import quantize_rtn  # noqa: E402
from repro_torch.core.evaluate import evaluate  # noqa: E402
from repro_torch.data import Corpus, CorpusConfig, make_batches  # noqa: E402
from repro_torch.deploy import QuantizedArtifact, export, tree_bytes  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.launch.train import train_step  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a GPU); cpu runs on the host")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg, model = get_model("brecq_lm_100m", reduced=True)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    params = model.init(torch.Generator(device=device).manual_seed(0))

    print(f"== training a tiny LM on the synthetic corpus ({device}) ==")
    acfg = adam.AdamConfig(lr=3e-3, grad_clip=1.0)
    state = adam.init(params)
    for i in range(TRAIN_STEPS):
        batch = make_batches(corpus, 1, 16, 64, seed=0, start_step=i)[0]
        batch = {k: v.to(device) for k, v in batch.items()}
        params, state, loss = train_step(model, acfg, params, state, batch, "none")
        if i % 50 == 0:
            print(f"  step {i}: loss {float(loss):.3f}")

    calib = make_batches(corpus, N_CALIB_BATCHES, 8, 64, seed=1, start_step=1000)
    evalb = make_batches(corpus, 4, 16, 64, seed=2, start_step=2000)

    print("\n== post-training quantization ==")
    fp = evaluate(model, params, evalb)
    print(f"  FP32     : ppl {fp['ppl']:.2f}  top1 {fp['top1']:.3f}")

    pq, _ = quantize_rtn(model, params, calib, w_bits=2)
    rtn = evaluate(model, pq, evalb)
    print(f"  RTN  W2  : ppl {rtn['ppl']:.2f}  top1 {rtn['top1']:.3f}")

    t0 = time.time()
    res = quantize(model, params, calib, ReconConfig(w_bits=2, iters=BRECQ_ITERS))
    brecq = evaluate(model, res.params_q, evalb)
    print(f"  BRECQ W2 : ppl {brecq['ppl']:.2f}  top1 {brecq['top1']:.3f} "
          f"(calibrated in {time.time()-t0:.0f}s on "
          f"{sum(b['tokens'].shape[0] for b in calib)} sequences)")

    print("\n== packed-int deployment artifact ==")
    art = export(model, res)
    with tempfile.TemporaryDirectory(prefix="brecq_quickstart_art_") as art_dir:
        art.save(art_dir)
        loaded = QuantizedArtifact.load(art_dir).to(device)
        dep = evaluate(model, loaded, evalb)
    fp_bytes = tree_bytes(params)
    print(f"  packed W2: ppl {dep['ppl']:.2f}  "
          f"{fp_bytes/1e6:.1f}MB fp32 -> {loaded.nbytes()/1e6:.1f}MB packed, "
          f"packed in {art.stats['pack_wall_s']:.2f}s "
          f"(bits histogram {art.stats['bits_histogram']})")
    assert loaded.nbytes() < fp_bytes
    return {"fp": fp, "rtn_w2": rtn, "brecq_w2": brecq, "packed_w2": dep}


if __name__ == "__main__":
    main()
