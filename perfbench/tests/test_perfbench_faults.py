"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference one precision down) put in the
program's place and judged by the driver's own comparison.

Each test drives the rest of a real run (the cell's driver, its window and
its comparison with the plain reference, with the cell's own limits) on
the CPU at a size a test run can hold, skipping the look for a chip. The
faults are planted in the program: a step that returns its state
unchanged, half of the batch left out with the mean over the rest, and an
answer altered where it is produced. The cells run on one chip, so no
exchange between chips can be left out.
"""
import time

import pytest
import torch

from perfbench import controls, harness

TINY = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
        "rope_theta": 1e6, "tie_word_embeddings": False, "hidden_act": "silu",
        "rms_norm_eps": 1e-6}
# the control needs logits of a realistic scale (they grow with the width):
# at TINY's width bfloat16's flips cost about the limit itself
WIDE = dict(TINY, hidden_size=1024, intermediate_size=2048, num_attention_heads=8,
            num_hidden_layers=1, vocab_size=2048)
CALIB = dict(TINY, num_key_value_heads=4, num_hidden_layers=3, tie_word_embeddings=True)
CPU = torch.device("cpu")
SPEC = harness.load_spec()
SERVE_CELLS = [w["name"] for w in SPEC["workloads"]
               if harness.load_mix(w["traffic"])["driver"] == "serve"]
# the calibration driver's mixes (no cell runs one yet; see PERF.md)
CALIB_MIXES = sorted(p.stem for p in harness.PKG.glob("mixes/*.json")
                     if harness.load_mix(p.stem)["driver"] == "calib")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_serve_mix(cell):
    mix = harness.load_mix(harness.cell(SPEC, cell)["traffic"])
    mix["prompt"].update(median=24, min=8, max=48)
    mix["output"].update(median=6, min=2, max=12)
    mix["engine"].update(prefill_chunk=16, max_len=64, num_slots=4, pool_tokens=256)
    mix["rate"] = 20.0
    return mix


def small_calib_mix(name):
    mix = harness.load_mix(name)
    mix.update(n_seqs=8, seq_len=32, iters=40, calib_bs=4)
    return mix


class _ServeFault:
    """The serving program broken underneath: the decode step keeps the KV
    pool as it was (``unchanged``), computes half the slots and hands their
    logits to the other half (``half``), or shifts every logit row by one
    token (``altered``)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import repro_torch.models.common as cm
        from repro_torch.models.transformer import LM

        self.saved = [(cm, "paged_append", cm.paged_append), (LM, "decode_step", LM.decode_step)]
        orig = LM.decode_step
        if self.name == "unchanged":
            cm.paged_append = lambda cache, k, v, bt, pos, ps: cache
        elif self.name == "half":
            def step(self_, params, tokens, cache, pos, *a, **k):
                lg, c = orig(self_, params, tokens, cache, pos, *a, **k)
                b = tokens.shape[0]
                if b > 1 and not k.get("all_logits"):
                    lg = torch.cat([lg[:b // 2], lg[:b - b // 2]], 0)
                return lg, c
            LM.decode_step = step
        elif self.name == "altered":
            def step(self_, *a, **k):
                lg, c = orig(self_, *a, **k)
                return torch.roll(lg, 1, dims=-1), c
            LM.decode_step = step
        return self

    def __exit__(self, *exc):
        for obj, attr, old in self.saved:
            setattr(obj, attr, old)


SECONDS = 3  # a loaded test machine still finishes some dozens of requests


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_serve_fault(cell, fault):
    drv = harness.load_driver("serve")
    mix = small_serve_mix(cell)
    if fault is None:
        run = drv.run(config=TINY, mix=mix, seed=2**31 + 3, seconds=SECONDS, trace=False,
                      device=CPU, t_start=time.perf_counter())
        assert run.correct, (run.checks, run.facts["finished"])
        return
    with _ServeFault(fault):
        run = drv.run(config=TINY, mix=mix, seed=2**31 + 3, seconds=SECONDS, trace=False,
                      device=CPU, t_start=time.perf_counter())
    assert run.facts["judged_requests"] >= mix["check"]["min_requests"], run.facts
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", CALIB_MIXES)
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_calib_fault(cell, fault):
    drv = harness.load_driver("calib")
    mix = small_calib_mix(cell)
    with controls._Faults(fault or "none"):
        run = drv.run(config=CALIB, mix=mix, seed=2**31 + 4, seconds=0.5, trace=False,
                      device=CPU, t_start=time.perf_counter())
    assert run.correct is (fault is None), run.checks


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serve_control(cell):
    mix = small_serve_mix(cell)
    mix["prompt"].update(median=12, min=4, max=24)
    mix["output"].update(median=24, min=12, max=40)
    mix["engine"].update(num_slots=8, pool_tokens=512)
    mix["check"].update(tokens=512, max_requests=96)
    prog, ctrl = controls.serve_readings(WIDE, mix, 2**31 + 5, 2 * SECONDS, CPU)
    assert prog["requests"] >= 4, prog
    assert prog["correct"] and prog["served_logit_gap"] <= mix["check"]["limit"], prog
    assert not ctrl["correct"] and ctrl["served_logit_gap"] > mix["check"]["limit"], ctrl


@pytest.mark.parametrize("cell", CALIB_MIXES)
def test_calib_control(cell):
    mix = small_calib_mix(cell)
    prog, ctrl = controls.calib_readings(CALIB, mix, 2**31 + 6, 0.5, CPU, False)
    c = mix["check"]
    assert prog["correct"], prog
    assert not ctrl["correct"], ctrl
    assert ctrl["loss_gap"] > c["loss_gap_limit"], ctrl
