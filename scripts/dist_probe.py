"""Which collectives the gloo backend takes, on this machine's torch.

For each of ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``, through both APIs:
``torch.distributed`` (``c10d``) and the functional collectives DTensor
calls (``functional``, ``torch.distributed._functional_collectives``).
Each (API, collective) runs in its own pair of spawned ranks over a
localhost store, all pairs at once, on tensors of the chosen device (both
ranks on the same device: gloo is the backend that lets two ranks share
one GPU), so a collective that crashes its ranks is recorded as such.
Prints one line per case, ``ok``, the error or the crash, and a JSON
summary as the last line.

    PYTHONPATH=src python scripts/dist_probe.py [--device cuda|cpu] [--api functional]
                                             [--deadline SECONDS]
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single")
APIS = ("c10d", "functional")


def _c10d(op: str, x: torch.Tensor, world: int):
    if op == "all_reduce":
        dist.all_reduce(x)
        return x
    if op == "all_gather_into_tensor":
        out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out
    if op == "reduce_scatter_tensor":
        out = torch.empty(x.numel() // world, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x)
        return out
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


def _functional(op: str, x: torch.Tensor, world: int):
    import torch.distributed._functional_collectives as fc

    group = dist.group.WORLD
    if op == "all_reduce":
        y = fc.all_reduce(x, "sum", group)
    elif op == "all_gather_into_tensor":
        y = fc.all_gather_tensor(x, 0, group)
    elif op == "reduce_scatter_tensor":
        y = fc.reduce_scatter_tensor(x, "sum", 0, group)
    else:
        y = fc.all_to_all_single(x, None, None, group)
    return fc.wait_tensor(y)


def _worker(rank: int, world: int, port: int, device: str, api: str, op: str, q) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    x = torch.arange(4 * world, dtype=torch.float32, device=device) + rank
    try:
        y = (_c10d if api == "c10d" else _functional)(op, x, world)
        if device == "cuda":
            torch.cuda.synchronize()
        res = f"ok {y.device.type}"
    except Exception as e:  # the probe records what the backend refuses
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if rank == 0:
        q.put((api, op, res))
    dist.destroy_process_group()


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--api", choices=APIS, action="append",
                    help="probe this API only (default: both)")
    ap.add_argument("--deadline", type=float, default=300.0,
                    help="seconds to wait for the cases; a case with no answer by "
                         "then is recorded as such")
    args = ap.parse_args(argv)
    apis = tuple(args.api or APIS)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pairs = {}
    for api in apis:
        for op in OPS:
            port = _port()
            pairs[(api, op)] = [ctx.Process(target=_worker,
                                            args=(r, 2, port, args.device, api, op, q))
                                for r in range(2)]
    for procs in pairs.values():
        for p in procs:
            p.start()
    res = {api: {} for api in apis}
    deadline = time.monotonic() + args.deadline
    while any(op not in res[api] for api, op in pairs) and time.monotonic() < deadline:
        try:
            api, op, r = q.get(timeout=1.0)
            res[api][op] = r
        except queue.Empty:
            for (api, op), procs in pairs.items():
                codes = [p.exitcode for p in procs]
                if op not in res[api] and any(c not in (None, 0) for c in codes):
                    res[api][op] = f"crashed, exit codes {codes}"
    for procs in pairs.values():
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    for api, op in pairs:
        res[api].setdefault(op, f"no answer in {args.deadline:g} s")
        print(f"gloo {args.device} {api:10s} {op:24s} {res[api][op]}")
    out = {"torch": torch.__version__, "device": args.device, "gloo": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(0 if main() else 1)
