"""Paper Table 1: reconstruction granularity ablation at 2-bit weights.

The port's counterpart of ``benchmarks/table1_granularity.py``. Claim
under test: block > layer and block > net at W2 (stage between)."""
from __future__ import annotations

from repro_torch.core import ReconConfig
from repro_torch.core.evaluate import evaluate

from .common import RECON_ITERS, cached_brecq, device_arg, emit, get_bench_model


def main(device=None) -> list[dict]:
    cfg, model, params, calib, evalb = get_bench_model(device=device)
    fp = evaluate(model, params, evalb)
    rows = [{"name": "fp32", "us_per_call": 0,
             "derived": f"loss={fp['loss']:.4f};top1={fp['top1']:.4f}"}]
    for gran in ("layer", "block", "stage", "net"):
        rc = ReconConfig(w_bits=2, iters=RECON_ITERS, granularity=gran,
                         use_fisher=(gran != "layer"))
        res = cached_brecq(model, params, calib, rc, f"t1_{gran}_w2")
        ev = evaluate(model, res["params_q"], evalb)
        rows.append({
            "name": f"{gran}_w2",
            "us_per_call": res["stats"]["calib_wall_s"] * 1e6,
            "derived": f"loss={ev['loss']:.4f};top1={ev['top1']:.4f}",
            "loss": ev["loss"], "top1": ev["top1"],
        })
    emit(rows, "table1")
    return rows


if __name__ == "__main__":
    main(device_arg())
