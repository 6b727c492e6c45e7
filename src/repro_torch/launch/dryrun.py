"""Dry run: trace every (arch x shape x mesh) cell at production scale.

The port of the JAX package's ``repro.launch.dryrun``, whose 512 XLA
placeholder devices become PyTorch's ``fake`` process-group backend: one
process joins a fake group of the mesh's size, builds the plan's
``DeviceMesh``, and runs the step (``launch/steps.py``) on fake DTensors
(``Step.trace``: shapes, no storage, every collective a no-op). Per cell
it writes ``artifacts/dryrun_torch/<arch>_<shape>_<mesh>[_tag].json``:

  * argument bytes per rank, exact from the plan's placements (params,
    optimizer state, batch, cache)
  * the peak bytes per rank: the arguments plus the most bytes of the
    rank's own tensors alive at once during the step (every storage an op
    makes, followed until its last tensor dies); ``fits_80gb`` is that
    peak under 80 GB. (``torch.distributed._tools.mem_tracker.MemTracker``
    under the fake group sees none of a DTensor step's activations.)
  * FLOPs per rank: ``torch.utils.flop_counter``'s formulas on each
    op's global shapes, divided by the mesh dims its output is sharded or
    partial over (a replicated dim computes the whole); bytes per rank:
    every op's operands and outputs, local shares, unfused
  * collectives per rank: counts (``CommDebugMode``) and the bytes of
    their local operands (``analysis/optrace.comm_mode``, which a measured
    step's summary shares)
  * the roofline terms on one H100 (``analysis/roofline.from_trace``) and
    ``fits_80gb``

``--all`` runs every applicable cell in a subprocess each (one bad cell
cannot take down the sweep), writing ``<name>.err`` for a failure.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reduced \\
        --arch tinyllama_1_1b --shape decode_32k --quant 4 --group 64 --tag w4
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import subprocess
import sys
import time
import weakref
from pathlib import Path

HBM_BYTES = 80e9  # one H100 SXM5


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--shape", type=str, default=None)
    p.add_argument("--mesh", choices=["single", "multi"], default="single")
    p.add_argument("--reduced", action="store_true",
                   help="reduced arch + toy shape on 8 ranks: (4, 2) data x model, "
                        "or (2, 2, 2) pod x data x model with --mesh multi")
    p.add_argument("--strategy", choices=["auto", "dp", "tp", "fsdp", "zero3"],
                   default="auto")
    p.add_argument("--quant", type=int, default=None, choices=[2, 4, 8],
                   help="serve with packed int weights at this bit-width")
    p.add_argument("--group", type=int, default=None, help="weight group size")
    p.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    p.add_argument("--moe-impl", default=None, choices=["dense", "capacity"])
    p.add_argument("--fsdp-axis", default="data")
    p.add_argument("--no-shard-experts", action="store_true")
    p.add_argument("--tag", default="", help="suffix for the artifact name")
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--all", action="store_true", help="run every cell (subprocesses)")
    p.add_argument("--include-quant", action="store_true",
                   help="with --all: also run int4 decode variants")
    p.add_argument("--timeout", type=int, default=1800)
    return p.parse_args(argv)


def _mesh(args):
    from .mesh import MeshSpec, make_production_mesh

    if args.reduced:  # 8 ranks
        if args.mesh == "multi":
            return MeshSpec((2, 2, 2), ("pod", "data", "model"))
        return MeshSpec((4, 2), ("data", "model"))
    return make_production_mesh(multi_pod=(args.mesh == "multi"))


def _split(t) -> int:
    """Ranks a DTensor's work is split over: the mesh dims it is sharded or
    partial on (1 for a plain tensor)."""
    mesh = getattr(t, "device_mesh", None)
    if mesh is None:
        return 1
    return math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                     if p.is_shard() or p.is_partial())


def _cost_mode():
    """A dispatch mode adding up FLOPs and bytes per rank (module doc): an
    op's bytes are its tensor operands read once and its outputs written
    once, per rank, with no fusion (as XLA's per-op cost analysis)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (list, tuple)):
            return [t for a in x for t in tensors(a)]
        return []

    class LocalCost(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.by_op = collections.Counter()
            self.live, self.cur, self.peak = {}, 0, 0  # storage -> [bytes, refs]

        def _born(self, t):
            key = t.untyped_storage()._cdata
            if key not in self.live:
                self.live[key] = [t.untyped_storage().nbytes(), 0]
                self.cur += self.live[key][0]
                self.peak = max(self.peak, self.cur)
            self.live[key][1] += 1
            weakref.finalize(t, self._dead, key)

        def _dead(self, key):
            entry = self.live.get(key)
            if entry is not None:
                entry[1] -= 1
                if entry[1] == 0:
                    self.cur -= entry[0]
                    del self.live[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = tensors(out)
            for t in outs:
                if not hasattr(t, "placements"):  # a rank's own tensor
                    self._born(t)
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None and outs:
                n = fn(*args, **kwargs, out_val=out) / _split(outs[0])
                self.flops += n
                self.by_op[str(func._overloadpacket)] += n
            if "view" not in str(func._overloadpacket):
                for t in tensors(args) + outs:
                    p = getattr(t, "placements", ())
                    shards = math.prod(t.device_mesh.size(i) for i, q in enumerate(p)
                                       if q.is_shard()) if p else 1
                    self.bytes += t.numel() * t.element_size() / shards
            return out

    return LocalCost()


def _tree_bytes(tree) -> int:
    """Bytes this rank holds of a tree of (fake) DTensors."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    local = tree.to_local() if hasattr(tree, "to_local") else tree
    return local.numel() * local.element_size()


def cell_step(args):
    """The cell's step on the fake group (joined here unless a group
    exists): (cfg, shape, mesh, strategy, step, fake args, build seconds)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..configs.base import SHAPES
    from ..dist.sharding import Plan, pick_strategy
    from ..models import get_model
    from . import steps as steps_mod

    cfg, model = get_model(args.arch, reduced=args.reduced, moe_impl=args.moe_impl)
    shape = SHAPES[args.shape]
    if args.reduced:
        shape = dataclasses.replace(shape, global_batch=min(shape.global_batch, 8),
                                    seq_len=min(shape.seq_len, 64))
    mesh = _mesh(args)
    strategy = (pick_strategy(cfg, shape.kind) if args.strategy == "auto"
                else args.strategy)
    plan = Plan(mesh=mesh, strategy=strategy, cfg=cfg, fsdp_axis=args.fsdp_axis,
                shard_experts=not args.no_shard_experts)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    dm = mesh.device_mesh("cpu")

    t0 = time.time()
    step = steps_mod.make_step(shape.kind, model, plan, shape, quant_bits=args.quant,
                               group=args.group, remat=args.remat)
    fake_args = step.fake_args(dm)
    return cfg, shape, mesh, strategy, step, fake_args, time.time() - t0


def run_cell(args) -> dict:
    import torch

    from ..analysis import roofline as rl
    from ..analysis.optrace import comm_mode
    from . import steps as steps_mod

    cfg, shape, mesh, strategy, step, fake_args, t_build = cell_step(args)
    arg_bytes = [_tree_bytes(a) for a in fake_args]
    steps_mod.GATHERS.clear()
    flops, comm = _cost_mode(), comm_mode()  # the collectives as optrace counts them
    t0 = time.time()
    with comm, flops:
        step.trace(fake_args)
    t_trace = time.time() - t0

    names = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch", "cache"),
             "decode": ("params", "tokens", "cache", "pos")}[shape.kind]
    arg_bytes = dict(zip(names, arg_bytes))
    args_total = sum(arg_bytes.values())
    coll_bytes = float(sum(comm.bytes.values()))
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    roof = rl.from_trace(flops.flops, flops.bytes, coll_bytes, cfg, shape, mesh.size,
                         w_bits=args.quant or 16)
    peak = args_total + flops.peak
    per_rank = peak
    return {
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "mesh_shape": dict(mesh.shape), "reduced": args.reduced,
        "n_chips": mesh.size, "strategy": strategy, "kind": shape.kind,
        "quant": args.quant, "group": args.group, "remat": args.remat,
        "moe_impl": args.moe_impl, "tag": args.tag, "torch": torch.__version__,
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "argument_bytes": arg_bytes, "argument_bytes_total": args_total,
        "peak_bytes": peak, "per_chip_bytes": per_rank,
        "fits_80gb": bool(per_rank < HBM_BYTES),
        "flops_per_rank": flops.flops, "bytes_per_rank": flops.bytes,
        "flops_by_op": dict(flops.by_op.most_common(8)),
        "collective_counts": counts, "collective_bytes": dict(comm.bytes),
        "collective_bytes_total": coll_bytes,
        "gathers": dict(steps_mod.GATHERS),
        "roofline": roof.as_dict(),
    }


def cell_list(include_quant: bool = False):
    from ..configs.base import applicable_shapes
    from ..models import ARCH_IDS, get_config

    cells = []
    for arch in ARCH_IDS:
        if arch == "brecq_lm_100m":
            continue  # paper model is exercised by benchmarks, not the 40-cell table
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            for mesh in ("single", "multi"):
                cells.append((arch, shape, mesh, None))
                if include_quant and shape in ("decode_32k", "long_500k") and mesh == "single":
                    cells.append((arch, shape, mesh, 4))
    return cells


def main(argv=None):
    args = parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = cell_list(args.include_quant)
        print(f"dry-run sweep: {len(cells)} cells")
        failures = []
        for arch, shape, mesh, quant in cells:
            tag = f"_w{quant}" if quant else ""
            name = f"{arch}_{shape}_{mesh}{tag}"
            path = outdir / f"{name}.json"
            if path.exists():
                print(f"[skip] {name} (cached)")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(outdir)]
            if quant:
                cmd += ["--quant", str(quant), "--tag", f"w{quant}"]
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            ok = r.returncode == 0 and path.exists()
            print(f"[{'ok' if ok else 'FAIL'}] {name} ({time.time()-t0:.0f}s)")
            if not ok:
                failures.append(name)
                (outdir / f"{name}.err").write_text(r.stdout[-4000:] + "\n---\n"
                                                    + r.stderr[-8000:])
        print(f"done: {len(cells) - len(failures)}/{len(cells)} ok")
        if failures:
            print("failures:", failures)
            sys.exit(1)
        return

    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape required (or --all)")
    out = run_cell(args)
    tag = f"_{args.tag}" if args.tag else ""
    path = outdir / f"{args.arch}_{args.shape}_{args.mesh}{tag}.json"
    path.write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({k: out[k] for k in
                      ("arch", "shape", "mesh", "strategy", "argument_bytes_total",
                       "peak_bytes", "fits_80gb", "flops_per_rank", "trace_s")},
                     default=float))
    print("collectives:", out["collective_counts"], out["collective_bytes"])
    print("roofline:", json.dumps(out["roofline"], indent=1, default=float))
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
