"""Run one job on several ranks of a local process group.

``run_ranks(job, world)`` spawns ``world`` processes, joins them in a gloo
group over a localhost TCP store and calls ``job(rank, world, *args)`` on
each; it returns the ranks' results in rank order. gloo is the backend
that lets several ranks share one GPU (NCCL refuses two ranks on one
device), so this is how a single card runs a multi-rank step, each rank
on ``cuda:0``. A rank that raises, or a run past ``timeout`` seconds,
fails the whole call with the ranks' tracebacks; every process is stopped
before it returns.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, job, args, out, timeout, stage):
    import faulthandler

    import torch.distributed as dist

    from .staging import STAGED, stage_through_host

    faulthandler.enable()  # a crashed rank says where
    faulthandler.dump_traceback_later(timeout, exit=True)  # and a hung one
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        stage_through_host(stage)
        res = job(rank, world, *args)
        out.put((rank, True, (res, dict(STAGED))))
        dist.destroy_process_group()
    except BaseException:  # the parent re-raises it with every rank's story
        out.put((rank, False, traceback.format_exc()))


# per rank, the collectives the last ``run_ranks`` staged through the host
LAST_STAGED: list = []


def run_ranks(job, world: int, *args, timeout: float = 600.0, stage=()) -> list:
    """``[job(0, world, *args), ..., job(world - 1, world, *args)]``, each
    on its own spawned rank. ``job`` must be importable by name (a module
    level function); its result must pickle. ``stage`` names functional
    collectives each rank runs through pinned host memory
    (``staging.stage_through_host``); their counts land in
    :data:`LAST_STAGED`."""
    import torch.multiprocessing as mp

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, port, job, args, out, timeout, tuple(stage)))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    t0 = time.monotonic()
    try:
        while len(results) + len(errors) < world and not errors:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:  # a rank died before it could report
                    time.sleep(1.0)  # its traceback may still be in flight
                    while not out.empty():
                        rank, ok, res = out.get()
                        (results if ok else errors)[rank] = res
                    lost = [r for r in dead if r not in results and r not in errors]
                    if lost and not errors:
                        raise RuntimeError(f"ranks {lost} of {job.__name__} exited with "
                                           f"{[procs[r].exitcode for r in lost]}")
                elif time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"{world - len(results)} ranks of {job.__name__} "
                                       f"gave no result in {timeout:.0f}s") from None
                continue
            (results if ok else errors)[rank] = res
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(f"--- rank {r} ---\n{tb}" for r, tb in
                                     sorted(errors.items())))
    LAST_STAGED[:] = [results[r][1] for r in range(world)]
    return [results[r][0] for r in range(world)]
