"""The port's deployment tables 6-8 (``benchmarks_torch``) on the CPU.

Table 7: the port's ``run_streams`` against JAX's on the reduced
brecq-lm-100m at a cut configuration (8 streams, 4 slots, prompt 16, gen
16, chunk 8, pages of 4; JAX's params carried across, both on packed W4
artifacts): int8 and fp16 pools and the pressure pair at the reference's
pool rule, every scheduler counter equal. Table 6: ``serve_bench`` writes
a file the reference's ``scripts/check_serve_bench.py`` passes, with the
tracked file's keys, and leaves the decode tier as it found it. Table 8:
``main(["--smoke"])`` on JAX's params, its deterministic rows against
JAX's ``weight_sens_table``, ``rtn_mixed_artifact``, ``budget_artifact``
and ``genetic_search``, and ``scripts/check_budget_bench.py``. Every
table's CLI takes the reference's flags and writes under
``artifacts/bench_torch/`` (here a temporary directory), never the root
``BENCH_*.json``.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from benchmarks import table7_serve_mt as j7
from benchmarks_torch import common, table6_deploy, table7_serve_mt, table8_budget
from repro.core.mixed_precision import GAConfig as JGAConfig
from repro.core.mixed_precision import fitness as jfitness
from repro.core.mixed_precision import genetic_search as jgenetic_search
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.deploy import budget as jb
from repro.models import get_model as j_get_model
from repro_torch.deploy import rtn_artifact
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.models import get_model
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "brecq_lm_100m"
T7_CUT = dict(streams=8, slots=4, prompt=16, gen=16, chunk=8, page_size=4, seed=0)
T7_POOL_FRAC = 0.35
T7_MODES = {"int8": ("int8", "none", False), "fp16": ("float16", "none", False),
            "pressure_none": ("int8", "none", True),
            "pressure_prompt": ("int8", "prompt", True)}
UNCOMPARED = ("sustained_tok_s", "compile_s")  # walls


@pytest.fixture(scope="module")
def reduced():
    """JAX's reduced brecq params from PRNGKey(0), and the same tree as CPU
    tensors for the port."""
    jcfg, jmodel = j_get_model(ARCH, reduced=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg, model = get_model(ARCH, reduced=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return {"jcfg": jcfg, "jmodel": jmodel, "jparams": jparams,
            "cfg": cfg, "model": model, "params": params}


def _pool_pages() -> int:
    """The reference's pressure pool: ``pool_frac`` of the worst case."""
    c = T7_CUT
    pages_per = -(-(c["prompt"] + c["gen"]) // c["page_size"])
    return 1 + max(pages_per, int(T7_POOL_FRAC * c["slots"] * pages_per))


@pytest.fixture(scope="module")
def jax_streams(reduced):
    """JAX's four table-7 runs at the cut configuration, once per module."""
    r = reduced
    art = j_rtn_artifact(r["jparams"], 4, cfg=r["jcfg"])
    out = {}
    for mode, (kv, oc, pressed) in T7_MODES.items():
        m = j7.run_streams(r["jmodel"], art.params, art.hook(), kv, overcommit=oc,
                           num_pages=_pool_pages() if pressed else None, **T7_CUT)
        out[mode] = j7._round_run(m)
    return out


@pytest.mark.parametrize("mode", list(T7_MODES))
def test_table7_run_streams_matches_jax(reduced, jax_streams, mode):
    r = reduced
    art = rtn_artifact(r["params"], 4, cfg=r["cfg"])
    kv, oc, pressed = T7_MODES[mode]
    m = table7_serve_mt.run_streams(r["model"], art.params, art.hook(), kv,
                                    overcommit=oc,
                                    num_pages=_pool_pages() if pressed else None,
                                    **T7_CUT)
    got = table7_serve_mt._round_run(m)
    want = jax_streams[mode]
    assert set(got) == set(want) == set(j7.RUN_KEYS) | {"streams_completed", "leaked_pages"}
    assert {k: v for k, v in got.items() if k not in UNCOMPARED} == \
        {k: v for k, v in want.items() if k not in UNCOMPARED}
    assert (got["streams_completed"], got["leaked_pages"]) == (T7_CUT["streams"], 0)
    if mode == "pressure_prompt":  # the pair tests admission under pressure
        assert want["preemptions"] >= 1 and want["replay_prefill_chunks"] >= 1
        assert got["mean_slot_occupancy"] > jax_streams["pressure_none"]["mean_slot_occupancy"]


def test_table7_schema_and_flags(monkeypatch, tmp_path):
    """``main`` takes the reference's flags and passes them to ``bench``;
    the schema keys are the reference's; the default output is under
    ``artifacts/bench_torch/``."""
    assert table7_serve_mt.SCHEMA_KEYS == j7.SCHEMA_KEYS
    assert table7_serve_mt.RUN_KEYS == j7.RUN_KEYS
    seen = {}
    monkeypatch.setattr(table7_serve_mt, "bench", lambda **kw: seen.update(kw))
    table7_serve_mt.main(["--streams", "8", "--slots", "4", "--prompt", "16", "--gen",
                          "16", "--chunk", "8", "--page-size", "4", "--seed", "3",
                          "--pool-frac", "0.5", "--out", str(tmp_path / "x.json"),
                          "--device", "cpu"])
    assert seen == dict(streams=8, slots=4, prompt=16, gen=16, chunk=8, page_size=4,
                        seed=3, pool_frac=0.5, out=str(tmp_path / "x.json"),
                        reduced=True, device="cpu")
    monkeypatch.setattr(common, "ART", tmp_path / "bench_torch")
    assert table7_serve_mt.mt_json() == tmp_path / "bench_torch" / "BENCH_serve_mt.json"
    assert table6_deploy.serve_json().name == "BENCH_serve.json"
    assert table8_budget.budget_json().parent == tmp_path / "bench_torch"


def test_default_outputs_are_not_the_tracked_files():
    for path in (table6_deploy.serve_json(), table7_serve_mt.mt_json(),
                 table8_budget.budget_json()):
        assert path.parent == ROOT / "artifacts" / "bench_torch"
        assert path.parent != ROOT


def test_table6_serve_bench_passes_the_reference_check(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "ART", tmp_path)
    tracked = (ROOT / "BENCH_serve.json").read_bytes()
    before = qmm_ops.set_decode_tier(True)  # a forced setting to be put back
    try:
        doc = table6_deploy.serve_bench(device="cpu")
        assert qmm_ops.decode_tier_enabled()
    finally:
        assert qmm_ops.set_decode_tier(before) is True
    assert (ROOT / "BENCH_serve.json").read_bytes() == tracked
    path = tmp_path / "BENCH_serve.json"
    assert json.loads(path.read_text()) == doc
    ref = json.loads(tracked)
    assert set(doc) == set(ref)
    assert set(doc["config"]) == set(ref["config"]) | {"device_name"}
    for k in ("fp", "packed_w4", "packed_w4_no_decode_tier"):
        assert set(doc[k]) == set(ref[k]) and set(doc[k]["qmm_tiers"]) == set(ref[k]["qmm_tiers"])
    assert doc["config"]["backend"] == doc["config"]["device_name"] == "cpu"
    assert doc["packed_w4"]["qmm_tiers"]["decode"] > 0
    assert doc["packed_w4_no_decode_tier"]["qmm_tiers"]["decode"] == 0
    assert doc["fp"]["qmm_tiers"] == {"decode": 0, "prefill": 0, "grouped": 0}
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_serve_bench.py"),
                          "--serve", str(path), "--mt", str(tmp_path / "absent.json"),
                          "--require", "serve", "--min-tier-ratio", "0"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_table6_cli_flags(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(table6_deploy, "serve_bench", lambda **kw: seen.update(kw))
    monkeypatch.setattr(table6_deploy, "main", lambda device: seen.update(main=device))
    table6_deploy.cli(["--serve-only", "--device", "cpu", "--out", str(tmp_path / "s.json")])
    assert seen == {"device": "cpu", "out": str(tmp_path / "s.json")}
    seen.clear()
    table6_deploy.cli(["--device", "cpu"])
    assert seen == {"main": "cpu"}


def test_table8_flags():
    args = table8_budget.parse_args(["--smoke", "--sens", "s.json", "--out", "o.json",
                                     "--seed", "2", "--full", "--device", "cpu"])
    assert (args.smoke, args.sens, args.out, args.seed, args.full, args.device) == \
        (True, "s.json", "o.json", 2, True, "cpu")
    args = table8_budget.parse_args([])
    assert (args.smoke, args.sens, args.out, args.seed, args.full, args.device) == \
        (False, None, None, 0, False, None)


def test_table8_smoke_matches_jax(reduced, monkeypatch, tmp_path):
    """The smoke sweep on JAX's params: unified bytes and predicted loss,
    every byte row's artifact bytes, bits and frontier, the domination
    list and the GA's fitness and cost equal JAX's on the same params;
    the reference's guard passes on the port's file."""
    r = reduced
    monkeypatch.setattr(table8_budget, "_init_params",
                        lambda model, seed, device: r["params"])
    out = table8_budget.main(["--smoke", "--device", "cpu", "--out",
                              str(tmp_path / "budget.json")])
    assert json.loads((tmp_path / "budget.json").read_text())["rows"] == \
        json.loads(json.dumps(out["rows"]))

    jsens = jb.weight_sens_table(r["jparams"], r["jcfg"].n_layers)
    paths = list(jsens.shapes)
    unified = {}
    for u in out["unified"]:
        b = u["bits"]
        art = jb.rtn_mixed_artifact(r["jparams"], {q: b for q in paths}, cfg=r["jcfg"])
        unified[b] = {"artifact_bytes": art.nbytes(),
                      "predicted_loss": jfitness(jsens, {q: b for q in paths})}
        assert u["artifact_bytes"] == unified[b]["artifact_bytes"]
        assert u["predicted_loss"] == pytest.approx(unified[b]["predicted_loss"], rel=1e-6)
    groups = jb.storage_groups(jsens.shapes)
    gsens, gtable, _ = jb.grouped_problem(jsens, jb.bytes_cost_table(jsens.shapes), groups)
    ga = JGAConfig(pop_size=24, iters=8, seed=0)
    u2, u4, u8 = (unified[b]["artifact_bytes"] for b in (2, 4, 8))
    assert [row["budget_bytes"] for row in out["rows"]] == [u2, (u4 + u8) // 2, u8]
    for row in out["rows"]:
        budget = row["budget_bytes"]
        art, sol, _ = jb.budget_artifact(r["jparams"], jsens, budget, kind="bytes",
                                         cfg=r["jcfg"])
        got = row["solver"]
        assert got["artifact_bytes"] == art.nbytes()
        assert got["bits_histogram"] == art.manifest["budget"]["bits_histogram"]
        assert got["n_frontier"] == sol.n_frontier
        assert got["predicted_loss"] == pytest.approx(sol.predicted_loss, rel=1e-6)
        dominated = sorted(b for b, u in unified.items()
                           if u["artifact_bytes"] <= budget
                           and sol.predicted_loss <= u["predicted_loss"] + 1e-12
                           and art.nbytes() <= u["artifact_bytes"])
        assert row["dominates_unified"] == dominated
        overhead = art.manifest["budget"]["overhead_bytes"]
        _, info = jgenetic_search(gsens, gtable, budget - overhead, ga)
        assert row["genetic"]["fitness"] == pytest.approx(info["fitness"], rel=1e-6)
        assert row["genetic"]["cost"] == info["cost"]
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_budget_bench.py"),
                          "--budget", str(tmp_path / "budget.json"), "--require",
                          "--min-tok-ratio", "0"], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
