"""Fault-tolerant training driver on one device.

The port of the JAX package's ``repro.launch.train`` (its single-device
path): the model's loss and its gradients by autograd, then Adam under a
cosine schedule with the global gradient norm clipped at 1.0. Fault
tolerance as in JAX: auto-resume from the newest complete checkpoint, an
async checkpoint every N steps and on SIGTERM/SIGINT, a per-step watchdog,
and data keyed by (seed, host, step), so a resumed run replays the
unbroken one exactly.

Runs on the GPU by default; ``--device cpu`` runs on the host. There is
no fallback: without a GPU and without ``--device cpu`` it raises. The
data-parallel int8 gradient all-reduce (``--grad-compress int8``) and the
model axis (``--model-shard``) are multi-device (ROADMAP item 15d) and
raise here.

    PYTHONPATH=src python -m repro_torch.launch.train --arch brecq_lm_100m \\
        --steps 300 --batch 16 --seq 128 --ckpt-dir artifacts/ckpt_100m
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..ckpt import CheckpointManager
from ..data import Corpus, CorpusConfig, arch_extras_fn, make_batches
from ..device import resolve
from ..interop import tree_leaves, tree_map
from ..models import get_model
from ..models.transformer import REMAT
from ..optim import adam
from .watchdog import GracefulShutdown, StepWatchdog

HOST = 0  # one process: the data stream of host 0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="brecq_lm_100m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", default="dots", choices=REMAT)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--grad-compress", choices=["none", "int8"], default="none")
    p.add_argument("--model-shard", type=int, default=1,
                   help="model-axis size of the mesh")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--metrics-out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the host)")
    args = p.parse_args(argv)
    if args.grad_compress == "int8" or args.model_shard > 1:
        raise NotImplementedError(
            "--grad-compress int8 and --model-shard > 1 are multi-device; the "
            "port trains on one device (ROADMAP item 15d)")
    return args


def loss_and_grads(model, params, batch: dict, remat: str):
    """The loss and its gradients w.r.t. every leaf of ``params`` (a tree
    of the same keys): ``jax.value_and_grad`` of the model's loss."""
    tree = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(tree)
    loss = model.loss(tree, batch, remat=remat)
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], tree)


def train_step(model, acfg: adam.AdamConfig, params, opt_state, batch: dict,
               remat: str):
    """One step: the loss and its gradients, then Adam. Returns (params,
    opt_state, loss)."""
    loss, grads = loss_and_grads(model, params, batch, remat)
    with torch.no_grad():
        params, opt_state = adam.update(acfg, grads, opt_state, params)
    return params, opt_state, loss


def main(argv=None):
    """Train; returns the params (on the training device)."""
    args = parse_args(argv)
    device = resolve(args.device)
    cfg, model = get_model(args.arch, reduced=args.reduced)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    extras_fn = arch_extras_fn(cfg)

    acfg = adam.AdamConfig(
        lr=adam.cosine_schedule(args.lr, args.warmup, args.steps),
        grad_clip=1.0)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    opt_state = adam.init(params)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        restored = ckpt.restore(start_step, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    watchdog = StepWatchdog()
    losses = []
    last_step = start_step  # stays put when resuming at/after completion
    t_start = time.time()
    with GracefulShutdown() as shutdown:
        for step in range(start_step, args.steps):
            last_step = step + 1
            batch = make_batches(corpus, 1, args.batch, args.seq, seed=args.seed,
                                 host=HOST, start_step=step, extras_fn=extras_fn)[0]
            batch = tree_map(lambda t: t.to(device), batch)
            watchdog.start()
            params, opt_state, loss = train_step(model, acfg, params, opt_state,
                                                 batch, args.remat)
            loss = float(loss)  # waits for the step
            watchdog.stop(step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"({watchdog.mean or 0:.3f}s/step)")
            if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                     or shutdown.requested):
                ckpt.save_async(step + 1, {"params": params, "opt": opt_state},
                                meta={"loss": loss, "arch": args.arch})
            if shutdown.requested:
                print(f"[shutdown] checkpointed at step {step + 1}; exiting")
                break
    if ckpt is not None:
        ckpt.wait()
        if losses:  # no steps ran -> the restored checkpoint already covers it
            ckpt.save(min(args.steps, last_step),
                      {"params": params, "opt": opt_state},
                      meta={"loss": losses[-1], "arch": args.arch})
    wall = time.time() - t_start
    print(f"done: {len(losses)} steps in {wall:.0f}s, "
          f"final loss {losses[-1]:.4f}" if losses else "no steps run")
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(
            {"arch": args.arch, "steps": len(losses), "wall_s": wall,
             "final_loss": losses[-1] if losses else None,
             "stragglers": watchdog.stragglers}))
    return params


if __name__ == "__main__":
    main()
