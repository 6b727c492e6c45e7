"""End-to-end driver on the port: train a ~100M-param LM, BRECQ-quantize it,
write the packed artifact.

    PYTHONPATH=src python examples/torch_train_then_quantize.py [--steps 300]

The PyTorch counterpart of ``examples/train_then_quantize.py``: pretraining
with the fault-tolerant trainer (``repro_torch.launch.train``, auto-resumes
from its checkpoints) -> block-reconstruction PTQ
(``repro_torch.core.quantize``) -> the packed deployment artifact
(``repro_torch.deploy.export``), which ``repro_torch.launch.serve
--artifact`` serves. Runs on the GPU; ``--device cpu`` with ``--small``
(the reduced config) runs on the host.

Its RTN line is not the JAX example's ``core/baselines.py::quantize_rtn``,
which the port does not have yet (ROADMAP item 15b), but
``repro_torch.core.rtn_on_scales``: every block weight rounded to nearest
on the scales BRECQ calibrated, the embedding and head as BRECQ quantized
them, which isolates what the learned rounding buys.
"""
import argparse
import time
from pathlib import Path

from repro_torch.core import ReconConfig, quantize, rtn_on_scales
from repro_torch.core.evaluate import evaluate
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.deploy import export, tree_bytes
from repro_torch.launch import train as train_mod
from repro_torch.models import get_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--out", default="artifacts/torch_example_e2e")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # 1) pretrain with the fault-tolerant driver (auto-resumes if re-run)
    train_args = ["--arch", "brecq_lm_100m", "--steps", str(args.steps),
                  "--batch", str(args.batch), "--seq", str(args.seq),
                  "--ckpt-dir", str(out / "ckpt"), "--ckpt-every", "100"]
    if args.small:
        train_args.append("--reduced")
    if args.device:
        train_args += ["--device", args.device]
    params = train_mod.main(train_args)

    # 2) calibrate with BRECQ (block granularity, Fisher-weighted)
    cfg, model = get_model("brecq_lm_100m", reduced=args.small)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    calib = make_batches(corpus, 8, 8, args.seq, seed=1, start_step=50_000)
    evalb = make_batches(corpus, 4, 8, args.seq, seed=2, start_step=60_000)

    fp = evaluate(model, params, evalb)
    t0 = time.time()
    res = quantize(model, params, calib,
                   ReconConfig(w_bits=args.w_bits, iters=args.iters))
    brecq = evaluate(model, res.params_q, evalb)
    rtn = evaluate(model, rtn_on_scales(model, params, res, calib[0]), evalb)
    print(f"\nFP ppl {fp['ppl']:.2f} | RTN-W{args.w_bits} ppl {rtn['ppl']:.2f} "
          f"| BRECQ-W{args.w_bits} ppl {brecq['ppl']:.2f} "
          f"({time.time()-t0:.0f}s calibration)")

    # 3) emit the packed deployment artifact (what the qmatmul kernels serve)
    art = export(model, res)
    art.save(str(out / f"artifact_w{args.w_bits}"))
    print(f"deployment artifact: {tree_bytes(params)/1e6:.1f}MB fp32 -> "
          f"{art.nbytes()/1e6:.1f}MB packed W{args.w_bits} "
          f"({out}/artifact_w{args.w_bits})")


if __name__ == "__main__":
    main()
