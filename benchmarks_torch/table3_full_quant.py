"""Paper Table 3: fully-quantized models (activations at 4-bit).

The port's counterpart of ``benchmarks/table3_full_quant.py``. W4A4 and
W2A4: RTN+calibrated act scales, LAPQ, AdaQuant, BRECQ (LSQ learned act
step sizes). Claim: BRECQ is the only usable W2A4."""
from __future__ import annotations

import time

from repro_torch.core import ReconConfig
from repro_torch.core.baselines import quantize_adaquant, quantize_lapq, quantize_rtn
from repro_torch.core.evaluate import evaluate
from repro_torch.device import resolve

from .common import (RECON_ITERS, cached_brecq, device_arg, emit, get_bench_model,
                     synchronize)

A_BITS = 4


def main(device=None) -> list[dict]:
    dev = resolve(device)
    cfg, model, params, calib, evalb = get_bench_model(device=dev)
    fp = evaluate(model, params, evalb)
    rows = [{"name": "fp32", "us_per_call": 0,
             "derived": f"loss={fp['loss']:.4f};top1={fp['top1']:.4f}"}]

    def add(name, fn):
        synchronize(dev)
        t0 = time.time()
        pq, scales = fn()
        synchronize(dev)
        wall = time.time() - t0
        ev = evaluate(model, pq, evalb, scales, a_bits=A_BITS)
        rows.append({"name": name, "us_per_call": wall * 1e6,
                     "derived": f"loss={ev['loss']:.4f};top1={ev['top1']:.4f}",
                     "loss": ev["loss"], "top1": ev["top1"]})
        print(f"  [{name}] loss {ev['loss']:.4f} top1 {ev['top1']:.4f}")

    for bits in (4, 2):
        add(f"rtn_w{bits}a{A_BITS}",
            lambda b=bits: quantize_rtn(model, params, calib, b, a_bits=A_BITS))
        add(f"lapq_w{bits}a{A_BITS}",
            lambda b=bits: quantize_lapq(model, params, calib, b, a_bits=A_BITS))
        add(f"adaquant_w{bits}a{A_BITS}",
            lambda b=bits: quantize_adaquant(model, params, calib, b,
                                             a_bits=A_BITS, iters=RECON_ITERS // 2))

        def brecq(b=bits):
            res = cached_brecq(model, params, calib,
                               ReconConfig(w_bits=b, a_bits=A_BITS,
                                           iters=RECON_ITERS),
                               f"t3_brecq_w{b}a{A_BITS}")
            return res["params_q"], res["act_scales"]

        add(f"brecq_w{bits}a{A_BITS}", brecq)
    emit(rows, "table3")
    return rows


if __name__ == "__main__":
    main(device_arg())
