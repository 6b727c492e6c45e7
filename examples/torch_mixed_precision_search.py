"""Mixed-precision search on the port (paper Sec. 3.4 end to end).

    PYTHONPATH=src python examples/torch_mixed_precision_search.py [--device cpu]

The PyTorch counterpart of ``examples/mixed_precision_search.py``:
calibrates unified 2/4/8-bit models, measures diagonal + intra-block
sensitivities (``core/sensitivity.py::measure``), runs the genetic
algorithm under a model-size budget and reports the chosen per-layer
bit-widths and the loss of each budget's calibrated model. Runs on the GPU
(the hardened forward through the ``fakequant`` kernel); ``--device cpu``
runs the plain PyTorch path on the host.
"""
import argparse

import torch

from repro_torch.core import ReconConfig, quantize
from repro_torch.core.evaluate import evaluate
from repro_torch.core.mixed_precision import GAConfig, genetic_search, model_bytes
from repro_torch.core.sensitivity import measure
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.device import resolve
from repro_torch.launch.train import train_step
from repro_torch.models import get_model
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a GPU); cpu runs on the host")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg, model = get_model("brecq_lm_100m", reduced=True)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    acfg = adam.AdamConfig(lr=3e-3, grad_clip=1.0)
    state = adam.init(params)
    for i in range(200):
        batch = make_batches(corpus, 1, 16, 64, seed=0, start_step=i)[0]
        batch = {k: v.to(device) for k, v in batch.items()}
        params, state, _ = train_step(model, acfg, params, state, batch, "none")

    calib = make_batches(corpus, 6, 8, 64, seed=1, start_step=1000)
    evalb = make_batches(corpus, 2, 16, 64, seed=2, start_step=2000)

    print("== unified-precision calibrations (2/4/8-bit) ==")
    results = {}
    for b in (2, 4, 8):
        results[b] = quantize(model, params, calib, ReconConfig(w_bits=b, iters=80))
        ev = evaluate(model, results[b].params_q, evalb)
        print(f"  W{b}: loss {ev['loss']:.4f}")

    print("== sensitivity lookup table ==")
    sens = measure(model, params, calib[:3], results, n_samples=16)
    print(f"  {len(sens.diag)} diagonal, {len(sens.offdiag)} intra-block entries")

    full8 = model_bytes(sens.shapes, {p: 8 for p in sens.shapes})
    for frac in (0.35, 0.5, 0.75):
        assign, info = genetic_search(
            sens, lambda a: model_bytes(sens.shapes, a), full8 * frac,
            GAConfig(pop_size=50, iters=100))
        res = quantize(model, params, calib,
                       ReconConfig(w_bits=4, iters=80, per_layer_bits=assign))
        ev = evaluate(model, res.params_q, evalb)
        hist = {b: sum(1 for v in assign.values() if v == b) for b in (2, 4, 8)}
        print(f"  budget {frac:.0%}: loss {ev['loss']:.4f}  bits histogram {hist}")


if __name__ == "__main__":
    main()
