"""Paper Table 2: weight-only PTQ at W4/W3/W2 vs the baseline set.

The port's counterpart of ``benchmarks/table2_weight_only.py``.
Methods: RTN(minmax), OMSE(= RTN with MSE scales), Bias-Correction,
AdaRound (layer-wise reconstruction), AdaQuant, BRECQ.
Claim: all are fine at W4; only BRECQ stays usable at W2.
"""
from __future__ import annotations

import time

from repro_torch.core import ReconConfig
from repro_torch.core.baselines import (quantize_adaquant, quantize_bias_correction,
                                        quantize_rtn)
from repro_torch.core.evaluate import evaluate
from repro_torch.device import resolve

from .common import (RECON_ITERS, cached_brecq, device_arg, emit, get_bench_model,
                     synchronize)


def main(device=None) -> list[dict]:
    dev = resolve(device)
    cfg, model, params, calib, evalb = get_bench_model(device=dev)
    fp = evaluate(model, params, evalb)
    rows = [{"name": "fp32", "us_per_call": 0,
             "derived": f"loss={fp['loss']:.4f};top1={fp['top1']:.4f}"}]

    def add(name, fn):
        synchronize(dev)
        t0 = time.time()
        pq = fn()
        synchronize(dev)
        wall = time.time() - t0
        ev = evaluate(model, pq, evalb)
        rows.append({"name": name, "us_per_call": wall * 1e6,
                     "derived": f"loss={ev['loss']:.4f};top1={ev['top1']:.4f}",
                     "loss": ev["loss"], "top1": ev["top1"]})
        print(f"  [{name}] loss {ev['loss']:.4f} top1 {ev['top1']:.4f}")

    for bits in (4, 3, 2):
        add(f"rtn_minmax_w{bits}",
            lambda b=bits: quantize_rtn(model, params, calib, b, scale_method="minmax")[0])
        add(f"omse_w{bits}",
            lambda b=bits: quantize_rtn(model, params, calib, b, scale_method="mse")[0])
        add(f"biascorr_w{bits}",
            lambda b=bits: quantize_bias_correction(model, params, calib, b)[0])
        add(f"adaround_w{bits}",  # layer-wise reconstruction, no Fisher
            lambda b=bits: cached_brecq(
                model, params, calib,
                ReconConfig(w_bits=b, iters=RECON_ITERS, granularity="layer",
                            use_fisher=False), f"t2_adaround_w{b}")["params_q"])
        add(f"adaquant_w{bits}",
            lambda b=bits: quantize_adaquant(model, params, calib, b,
                                             iters=RECON_ITERS // 2)[0])
        add(f"brecq_w{bits}",
            lambda b=bits: cached_brecq(
                model, params, calib,
                ReconConfig(w_bits=b, iters=RECON_ITERS),
                f"t2_brecq_w{b}")["params_q"])
    emit(rows, "table2")
    return rows


if __name__ == "__main__":
    main(device_arg())
