"""Calibration window: the port's BRECQ ``quantize`` with a journal, stopped
by a signal.

Set-up makes the FP weights and the calibration tokens from the seed and
warms every shape the window uses by a short ``quantize`` of one layer of
the same model over the same tokens (a few iterations). The window then
drives ``quantize(model, params, batches, rc, workdir=<fresh directory in
TMPDIR>)``; from ``--seconds`` on the harness sends its own process SIGINT,
the port's documented way to stop a journaled calibration: the unit in
flight finishes, its snapshot is written, and ``CalibrationInterrupted``
is raised. (A calibration that finishes every unit first returns
normally.) The window's wall ends there, and ``calib_iters_per_s`` counts
the optimisation iterations of the journaled units over it.

A traced run profiles the whole window: every unit's Fisher pass, forward
programs, 800 iterations, hardened forwards (K5) and snapshot.

After the window the program's state is freed, and the plain reference
(``reference/calib.py``) follows the journaled units.
"""
from __future__ import annotations

import os
import shutil
import signal
import tempfile
import threading
import time
from pathlib import Path

import torch

from perfbench import harness, port, weights
from perfbench.trace import CallBounds, Window
from perfbench.work import flops as wflops


def recon_config(mix: dict, seed: int, iters=None):
    from repro_torch.core.reconstruction import ReconConfig

    return ReconConfig(w_bits=mix["w_bits"], granularity=mix["granularity"],
                       iters=iters or mix["iters"], calib_bs=mix["calib_bs"],
                       lr_v=mix["lr_v"], lam=mix["lam"], scale_method=mix["scale_method"],
                       stream_dtype=mix["stream_dtype"], fisher_mode=mix["fisher_mode"],
                       seed=seed)


def batches(tokens: torch.Tensor, bs: int) -> list[dict]:
    return [{"tokens": tokens[a:a + bs]} for a in range(0, tokens.shape[0], bs)]


def _one_layer(params: dict) -> dict:
    """The first layer of the stacked body, with the rest of the tree."""
    out = dict(params)

    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:1]

    out["body"] = cut(params["body"])
    return out


def build(config: dict, mix: dict, seed: int, device):
    from repro_torch.core.reconstruction import quantize

    t0 = time.perf_counter()
    arch, model = port.model(config)
    params = weights.make_params(model, seed, device)
    tokens = weights.calib_tokens(seed, mix["n_seqs"], mix["seq_len"],
                                  config["vocab_size"], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    # warm-up: every kernel and shape of a unit, on one layer of the model
    _a1, m1 = port.model(dict(config, num_hidden_layers=1))
    quantize(m1, _one_layer(params), batches(tokens, mix["calib_bs"]),
             recon_config(mix, seed, iters=3))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steps = {"weights_s": t1 - t0, "warm_s": time.perf_counter() - t1}
    return model, params, tokens, steps


class _Stopper(threading.Thread):
    """From ``seconds`` on, sends this process SIGINT every 0.5 s until
    ``done`` is set. ``quantize`` takes the first one it sees while its
    journal's handler is installed; one that comes before that handler or
    after it is restored meets the no-op handler the window installs."""

    def __init__(self, seconds: float):
        super().__init__(daemon=True)
        self.seconds, self.done = seconds, threading.Event()

    def run(self):
        if self.done.wait(self.seconds):
            return
        while not self.done.is_set():
            os.kill(os.getpid(), signal.SIGINT)
            self.done.wait(0.5)


def read_journal(workdir: Path) -> dict:
    """The latest snapshot: per-unit stats, rounding logits, x_q."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(workdir), keep=1)
    step = mgr.latest_step()
    meta = mgr.manifest(step)["meta"]
    tree = mgr.restore_nested(step)
    x_q = tree["x_q"]
    if "x_q" in meta.get("bf16", []):
        x_q = x_q.view(torch.bfloat16)
    v = {k.replace("%2F", "/"): t for k, t in tree.get("v", {}).items()}
    return {"units": meta["units"], "v": v, "x_q": x_q, "next_unit": meta["next_unit"]}


def window(model, params, tokens, config: dict, mix: dict, seed: int, seconds: float,
           trace: bool, device):
    from repro_torch.core.journal import CalibrationInterrupted
    from repro_torch.core.reconstruction import quantize
    workdir = Path(tempfile.mkdtemp(prefix="perfbench_journal_"))
    rec = CallBounds("fakequant").install() if trace else None
    tw = Window() if trace else None
    stopper = _Stopper(seconds)
    interrupted = False
    prev_int = signal.signal(signal.SIGINT, lambda signum, frame: None)
    if tw is not None:
        tw.start()
        rec.active = True
    t0 = time.perf_counter()
    stopper.start()
    try:
        quantize(model, params, batches(tokens, mix["calib_bs"]), recon_config(mix, seed),
                 workdir=str(workdir))
    except CalibrationInterrupted:
        interrupted = True
    finally:
        t1 = time.perf_counter()
        stopper.done.set()
        stopper.join()
        signal.signal(signal.SIGINT, prev_int)
    if tw is not None:
        rec.active = False
        tw.stop()
        rec.remove()
    journal = read_journal(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    return t1 - t0, journal, interrupted, rec, tw


def checks(got: dict, mix: dict) -> list:
    c = mix["check"]
    return [("loss_gap", got["loss_gap"], c["loss_gap_limit"]),
            ("stream_gap", got["stream_gap"], c["stream_gap_limit"])]


def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> harness.Run:
    from perfbench.reference.calib import CalibRef, judge
    from perfbench.reference.model import no_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    model, params, tokens, steps = build(config, mix, seed, device)
    t_setup = time.perf_counter()
    wall, journal, interrupted, rec, tw = window(model, params, tokens, config, mix, seed,
                                                 seconds, trace, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    units = journal["units"]
    iters = sum(int(u["opt_iters"]) for u in units)
    iter_flops = sum(int(u["opt_iters"]) * wflops.unit_iter_flops(
        config, len(u["unit"]), int(u["calib_bs"]), mix["seq_len"]) for u in units)
    facts = {"window_s": wall, "units": units, "iter_flops": iter_flops,
             "interrupted": interrupted, "fakequant_bound_s": rec.bound_s if rec else 0.0,
             "fakequant_calls": rec.calls if rec else 0,
             **steps}
    t_ref = time.perf_counter()
    no_tf32()
    ref = CalibRef(params, config, mix, tokens)
    got = judge(ref, {"units": units, "v": {k: t.to(device) for k, t in journal["v"].items()},
                      "x_q": journal["x_q"].to(device)}, seed, mix["check"]["steps"])
    facts["ref_s"] = time.perf_counter() - t_ref
    e2e = {"calib_iters_per_s": iters / wall, "setup_s": t_setup - t_start}
    failed = sum(1 for u in units if u.get("fallback"))
    return harness.Run(end_to_end=e2e, attempted=len(units), failed=failed, checks=checks(got, mix),
                       memory_peak_bytes=peak, facts=facts, trace=tw)
