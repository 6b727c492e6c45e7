"""Fault-tolerant trainer.

The port of the JAX package's ``repro.launch.train``: the model's loss and
its gradients by autograd, then Adam under a cosine schedule with the
global gradient norm clipped at 1.0. Fault tolerance as in JAX:
auto-resume from the newest complete checkpoint, an async checkpoint every
N steps and on SIGTERM/SIGINT, a per-step watchdog, and data keyed by
(seed, host, step), so a resumed run replays the unbroken one exactly.

One process on one device runs the plain step. ``--grad-compress int8``
runs the data-parallel step with the int8 error-feedback all-reduce
(``optim/grad_compress.py``) over the process group; ``--model-shard m``
lays the ranks out as a (world / m, m) data x model mesh and runs
``launch/steps.make_train_step`` under the plan ``pick_strategy`` gives
(at world 1 with ``--model-shard 1``, the plain step). Under ``torchrun``
the ranks join the group its environment names; a plain ``python -m``
run that needs a group starts a one-rank group itself (gloo on the CPU,
nccl on the card). Every rank builds the same global batch and takes its
rows; rank 0 alone prints and writes checkpoints of whole tensors, so a
sharded run resumes in the one-device trainer and in JAX's.

Runs on the GPU by default; ``--device cpu`` runs on the host. There is
no fallback: without a GPU and without ``--device cpu`` it raises.

    PYTHONPATH=src python -m repro_torch.launch.train --arch brecq_lm_100m \\
        --steps 300 --batch 16 --seq 128 --ckpt-dir artifacts/ckpt_100m
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --reduced --grad-compress int8 --device cpu --steps 4 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import json
import os
import socket
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
    if args.grad_compress == "int8" and args.model_shard > 1:
        # the int8 all-reduce step is DP-only: it splits the batch over the
        # "data" axis and would silently ignore a model axis
        p.error("--grad-compress int8 is DP-only and ignores a model axis; "
                "use --model-shard 1 or --grad-compress none")
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


def _join_group(device: torch.device) -> bool:
    """Join the process group: ``torchrun``'s, from its environment, or a
    one-rank group of our own. Returns whether this call started it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    return True


def _device(name) -> torch.device:
    """The training device; under ``torchrun`` each rank takes the card of
    its local rank."""
    device = resolve(name)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    return device


def main(argv=None):
    """Train; returns the params (on the training device; whole tensors)."""
    args = parse_args(argv)
    device = _device(args.device)
    cfg, model = get_model(args.arch, reduced=args.reduced)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    extras_fn = arch_extras_fn(cfg)

    acfg = adam.AdamConfig(
        lr=adam.cosine_schedule(args.lr, args.warmup, args.steps),
        grad_clip=1.0)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % args.model_shard:  # before any process group starts
        raise ValueError(f"a model axis of {args.model_shard} does not divide the "
                         f"{world} ranks of the process group")
    distributed = args.grad_compress == "int8" or args.model_shard > 1 or world > 1
    started = _join_group(device) if distributed else False
    try:
        return _train(args, device, cfg, model, corpus, extras_fn, acfg, distributed)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, device, cfg, model, corpus, extras_fn, acfg, distributed):
    from .mesh import make_host_mesh, world_size

    rank = 0
    if distributed:
        import torch.distributed as dist

        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    opt_state = adam.init(params)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        restored = ckpt.restore(start_step, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        say(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = None  # the plain step
    if args.grad_compress == "int8":
        from ..optim.grad_compress import init_error, make_dp_train_step

        err = init_error(params)
        dp_step = make_dp_train_step(model, make_host_mesh(1), acfg, remat=args.remat)

        def step_fn(params, opt_state, batch):
            nonlocal err
            params, opt_state, err, loss = dp_step(params, opt_state, err, batch)
            return params, opt_state, loss
    elif distributed:
        step_fn, params, opt_state = _sharded_step(args, device, cfg, model, acfg,
                                                   make_host_mesh(args.model_shard),
                                                   params, opt_state)
    if distributed:
        say(f"[mesh] {world_size()} ranks, --grad-compress {args.grad_compress}, "
            f"--model-shard {args.model_shard}")
    whole = _whole_fn(distributed and args.grad_compress != "int8")

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
            if step_fn is None:
                params, opt_state, loss = train_step(model, acfg, params, opt_state,
                                                     batch, args.remat)
            else:
                params, opt_state, loss = step_fn(params, opt_state, batch)
            loss = float(whole(loss))  # waits for the step
            watchdog.stop(step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d}  loss {loss:.4f}  "
                    f"({watchdog.mean or 0:.3f}s/step)")
            save = ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                         or shutdown.requested)
            if save:
                state = whole({"params": params, "opt": opt_state})
                if rank == 0:
                    ckpt.save_async(step + 1, state, meta={"loss": loss, "arch": args.arch})
            if shutdown.requested:
                say(f"[shutdown] checkpointed at step {step + 1}; exiting")
                break
    if ckpt is not None:
        state = whole({"params": params, "opt": opt_state}) if losses else None
        if rank == 0:
            ckpt.wait()
            if losses:  # no steps ran -> the restored checkpoint already covers it
                ckpt.save(min(args.steps, last_step), state,
                          meta={"loss": losses[-1], "arch": args.arch})
    wall = time.time() - t_start
    say(f"done: {len(losses)} steps in {wall:.0f}s, "
        f"final loss {losses[-1]:.4f}" if losses else "no steps run")
    if args.metrics_out and rank == 0:
        Path(args.metrics_out).write_text(json.dumps(
            {"arch": args.arch, "steps": len(losses), "wall_s": wall,
             "final_loss": losses[-1] if losses else None,
             "stragglers": watchdog.stragglers}))
    return whole(params)


def _whole_fn(sharded: bool):
    """Gathers DTensors to whole tensors (every rank takes part); the
    identity off the sharded path."""
    if not sharded:
        return lambda tree: tree
    from .steps import full_tree

    return full_tree


def _sharded_step(args, device, cfg, model, acfg, mesh, params, opt_state):
    """``launch/steps.make_train_step`` under ``Plan(mesh,
    pick_strategy(cfg, "train"))``, with params and optimizer state laid out
    once; each step lays out the rank's view of the global batch."""
    from ..configs.base import ShapeSpec
    from ..dist.sharding import Plan, pick_strategy
    from .steps import make_train_step, shard_tree

    plan = Plan(mesh=mesh, strategy=pick_strategy(cfg, "train"), cfg=cfg)
    step = make_train_step(model, plan, ShapeSpec("train", args.seq, args.batch, "train"),
                           acfg, remat=args.remat)
    dm = mesh.device_mesh(device.type)
    lay = step.layout(params, opt_state, None)[0]
    params, opt_state = shard_tree(params, lay[0], dm), shard_tree(opt_state, lay[1], dm)

    def step_fn(params, opt_state, batch):
        lay = step.layout(params, opt_state, batch)[0]
        params, opt_state, metrics = step.run(params, opt_state,
                                              shard_tree(batch, lay[2], dm))
        return params, opt_state, metrics["loss"]

    return step_fn, params, opt_state


if __name__ == "__main__":
    main()
