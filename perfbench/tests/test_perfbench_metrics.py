"""The per-layer readers and the trace reduction on synthetic inputs."""
import pytest

from perfbench import harness, trace
from perfbench.work import peaks


class FakeWindow(trace.Window):
    def __init__(self, events, samples, t0=0.0, t1=1.0):
        super().__init__(thread_id=1)
        self.device_events, self.samples, self.t0, self.t1 = events, samples, t0, t1


def read(name, run):
    return harness.load_metric(name).read(run)


def _run(facts, tw=None):
    return harness.Run(end_to_end={}, attempted=1, failed=0, checks=[("x", 0.0, 1.0)],
                       memory_peak_bytes=0, facts=facts, trace=tw)


EVENTS = [  # name, start ns, end ns
    ("void (anonymous namespace)::qmm_wide_kernel<4, false>(float const*)", 0, 300_000_000),
    ("at::native::elementwise_kernel", 200_000_000, 400_000_000),
    ("void (anonymous namespace)::qgemv_tc_kernel<8>(float const*)", 600_000_000, 700_000_000),
    ("fq_vec4_kernel", 800_000_000, 850_000_000),
]
SAMPLES = [(450_000_000, "serve_engine.engine._decode_all"),
           (500_000_000, "serve_engine.engine._decode_all"),
           (550_000_000, "models.mlp.apply"),
           (750_000_000, "kernels.qmatmul.ops.qmm")]


def test_trace_reduction():
    tw = FakeWindow(EVENTS, SAMPLES)
    assert tw.busy_s == pytest.approx(0.55)
    assert tw.family_time_s("qmm") == (pytest.approx(0.4), 2)
    assert tw.family_time_s("fakequant") == (pytest.approx(0.05), 1)
    gaps = tw.idle_gaps()
    assert gaps[0] == ["serve_engine.engine._decode_all", pytest.approx(0.2)]
    assert gaps[1] == ["kernels.qmatmul.ops.qmm", pytest.approx(0.1)]
    top = tw.top_ops()
    assert top[0][1] == pytest.approx(0.3) and len(top) == 4


@pytest.mark.parametrize("moves", ["ttft", "tput"])
def test_serve_readers(moves):
    tw = FakeWindow(EVENTS, SAMPLES, 0.0, 2.0)
    facts = {"ticks": [4.0, 6.0], "decode_ticks": 4, "tokens_generated": 30,
             "qmm_bound_s": 0.1, "qmm_calls": 5, "model_flops": 989e12 * 0.5, "window_s": 20.0}
    run = _run(facts, tw)
    tick = "tick_ms.itl" if moves == "ttft" else "tick_ms.tput"
    assert read(tick, run) == pytest.approx(5000.0)
    assert read("decode_batch.tput", run) == pytest.approx(7.5)
    assert read(f"qmm_roofline.{moves}", run) == pytest.approx(25.0)
    assert read(f"device_idle.{moves}", run) == pytest.approx(100 * (1 - 0.55 / 2.0))
    assert read(f"step_mfu.{moves}", run) == pytest.approx(5.0)  # over the ticks' 10 s


def test_calib_readers():
    tw = FakeWindow(EVENTS, SAMPLES, 0.0, 1.0)
    units = [{"opt_iters": 800, "opt_wall_s": 12.0}, {"opt_iters": 800, "opt_wall_s": 13.0}]
    facts = {"units": units, "window_s": 30.0, "iter_flops": 989e12 * 3.0,
             "fakequant_bound_s": 0.01, "fakequant_calls": 14}
    run = _run(facts, tw)
    assert read("unit_overhead.calib", run) == pytest.approx(100 * (1 - 25 / 30))
    assert read("opt_iter_ms.calib", run) == pytest.approx(1e3 * 25 / 1600)
    assert read("fq_roofline.calib", run) == pytest.approx(20.0)
    assert read("device_idle.calib", run) == pytest.approx(45.0)
    assert read("step_mfu.calib", run) == pytest.approx(10.0)


def test_readers_find_nothing():
    run = _run({})
    for path in sorted(harness.PKG.glob("metrics/*.py")):
        assert read(path.stem, run) is None, path.stem


def test_call_bounds():
    """The traced part's bound: each qmm call reckoned from the dims it hands
    ``record.call``, with the frozen formula; other families' calls left out."""
    from perfbench.trace import CallBounds
    from perfbench.work import kernels
    from repro_torch.kernels import record

    orig = record.call
    cb = CallBounds("qmm").install()
    try:
        cb.active = True
        with record.call(record.qmm_work, "qmatmul", 1, 512, 6144, 16384, 4, 1):
            pass
        with record.call(record.fq_work, 768, 768, 1):
            pass
        cb.active = False
        with record.call(record.qmm_work, "qgemv", 1, 8, 6144, 6144, 4, 1):
            pass
    finally:
        cb.remove()
    assert record.call is orig
    assert cb.calls == 1
    assert cb.bound_s == pytest.approx(peaks.bound_s(*kernels.qmm_work(1, 512, 6144, 16384, 4, 1)))


def test_bound():
    assert peaks.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_result_line_keys():
    spec = harness.load_spec()
    run = harness.Run(end_to_end={"serve_tok_s": 1.0, "ttft_p95_ms": 2.0, "itl_p95_ms": 3.0,
                                  "setup_s": 4.0},
                      attempted=3, failed=0, checks=[("served_logit_gap", 0.0, 0.1)],
                      memory_peak_bytes=7)
    line = harness.result_line(spec, "internlm2.serve_code", run, False, {"platform": "gpu"})
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert set(line["metrics"]) == {"ttft_p95_ms", "itl_p95_ms", "setup_s"}
    line = harness.result_line(spec, "internlm2.serve_chat", run, False, {"platform": "gpu"})
    assert set(line["metrics"]) == {"serve_tok_s", "setup_s"}
    bad = harness.Run(end_to_end={}, attempted=1, failed=0,
                      checks=[("g", float("nan"), 1.0)], memory_peak_bytes=0)
    assert bad.correct is False
