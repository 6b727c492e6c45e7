"""The port's paper tables (``benchmarks_torch``) on the CPU.

The bench configuration and batches against the JAX package's
``benchmarks/common.py``, table 4's ``qat_ste`` against JAX's on the
reduced brecq-lm-100m cut to 1 layer (2 steps), and every table's
``main()`` end to end at a tiny size (``tiny_bench``), the cache in a
temporary directory. Each table's rows carry the reference table's names.

fig2's measured cost table times the plain tiers by the host clock here
(``measure_cost_table(device='cpu')``); on the card it times K1/K2.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import table4_cost as jtable4
from benchmarks_torch import (common, fig2_mixed_precision, table1_granularity,
                              table2_weight_only, table3_full_quant, table4_cost,
                              table5_calib_speed, table6_deploy)
from repro.core.evaluate import evaluate as jevaluate
from repro.models import build_model as j_build_model
from repro.models import get_config as j_get_config
from repro_torch.core.evaluate import evaluate
from repro_torch.core.mixed_precision import GAConfig
from repro_torch.interop import flatten_paths, params_from_numpy, params_to_numpy
from repro_torch.models import build_model, get_config
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_bench_config_and_sizes_match_jax():
    assert dataclasses.asdict(common.bench_config()) == dataclasses.asdict(
        jcommon.bench_config())
    for k in ("BENCH_ARCH", "TRAIN_STEPS", "BATCH", "SEQ", "N_CALIB", "RECON_ITERS"):
        assert getattr(common, k) == getattr(jcommon, k), k


def test_bench_batches_match_jax(tmp_path, monkeypatch):
    """Both packages' ``get_bench_model`` with no training: the same
    calibration and eval batches. JAX's loads whatever its cache holds (a
    stand-in tree here), the port's trains 0 steps."""
    (tmp_path / "jax").mkdir()
    with open(tmp_path / "jax" / "bench_params.pkl", "wb") as f:
        pickle.dump({"w": np.zeros(1, np.float32)}, f)
    monkeypatch.setattr(jcommon, "ART", tmp_path / "jax")
    monkeypatch.setattr(common, "ART", tmp_path / "torch")
    *_, jcal, jeval = jcommon.get_bench_model()
    *_, cal, evalb = common.get_bench_model(train_steps=0, device="cpu")
    assert (len(cal), len(evalb)) == (len(jcal), len(jeval)) == (8, 4)
    for t, j in zip(cal + evalb, jcal + jeval):
        assert list(t) == list(j) == ["tokens"]
        np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))


def test_qat_ste_matches_jax():
    """2 STE QAT steps on the reduced model cut to 1 layer (JAX compiles
    the whole unrolled loss and its gradient), re-baked at RTN W4: loss
    within 1e-5 relative, baked leaves within 1e-4 * max|leaf|."""
    cfg = dataclasses.replace(j_get_config("brecq_lm_100m", reduced=True), n_layers=1)
    jmodel, model = j_build_model(cfg), build_model(
        dataclasses.replace(get_config("brecq_lm_100m", reduced=True), n_layers=1))
    p = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jpq, _, jtokens = jtable4.qat_ste(jmodel, jax.tree.map(jnp.asarray, p), cfg, steps=2)
    pq, wall, tokens = table4_cost.qat_ste(model, params_from_numpy(p, device="cpu"),
                                           cfg, steps=2)
    assert tokens == jtokens == 2 * common.BATCH * common.SEQ and wall > 0
    got, want = flatten_paths(params_to_numpy(pq)), flatten_paths(
        jax.tree.map(np.asarray, jpq))
    assert sorted(got) == sorted(want)
    for k in want:
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= 1e-4 * float(np.max(np.abs(want[k]))), (k, err)
    # the 2 steps moved the params: the re-baked weights are not init's RTN
    assert not np.array_equal(got["body/sub0/attn/wq/w"],
                              flatten_paths(p)["body/sub0/attn/wq/w"])
    from repro.data import Corpus, CorpusConfig, make_batches

    ev = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 1, 4, 32, seed=2)
    tev = [{"tokens": torch.from_numpy(np.array(b["tokens"])).long()} for b in ev]
    np.testing.assert_allclose(evaluate(model, pq, tev)["loss"],
                               jevaluate(jmodel, jpq, ev)["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# every table end to end at a tiny size
# ---------------------------------------------------------------------------

TINY_ITERS = 2
# the bench model at the reduced brecq-lm-100m's widths; 2 calibration
# batches of 8 x 32 tokens, training and QAT batches of 4 x 32
TINY_WIDTHS = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
TINY_BATCH, TINY_SEQ, TINY_CALIB = 4, 32, 16
TABLE_ROWS = {
    "table1_granularity": (table1_granularity, [
        "fp32", "layer_w2", "block_w2", "stage_w2", "net_w2"]),
    "table2_weight_only": (table2_weight_only, [
        "fp32",
        "rtn_minmax_w4", "omse_w4", "biascorr_w4", "adaround_w4", "adaquant_w4", "brecq_w4",
        "rtn_minmax_w3", "omse_w3", "biascorr_w3", "adaround_w3", "adaquant_w3", "brecq_w3",
        "rtn_minmax_w2", "omse_w2", "biascorr_w2", "adaround_w2", "adaquant_w2", "brecq_w2"]),
    "table3_full_quant": (table3_full_quant, [
        "fp32", "rtn_w4a4", "lapq_w4a4", "adaquant_w4a4", "brecq_w4a4",
        "rtn_w2a4", "lapq_w2a4", "adaquant_w2a4", "brecq_w2a4"]),
    "table4_cost": (table4_cost, [
        "fp32", "brecq_w4", "deploy_w4", "qat_ste_w4", "speedup"]),
    "table5_calib_speed": (table5_calib_speed, [
        "layer_python", "layer_scan", "layer_speedup",
        "block_python", "block_scan", "block_speedup",
        "stage_python", "stage_scan", "stage_speedup",
        "net_python", "net_scan", "net_speedup"]),
    "table6_deploy": (table6_deploy, [
        "serve_reduced_fp", "serve_reduced_packed_w4",
        "pack_w2_gchan", "pack_w2_g64", "pack_w4_gchan", "pack_w4_g64",
        "pack_w8_gchan", "pack_w8_g64", "export_brecq_w4", "serve_fp",
        "serve_packed_w4"]),
    "fig2_mixed_precision": (fig2_mixed_precision, [
        "unified_w2", "unified_w4", "unified_w8",
        "mixed_35pct", "mixed_50pct", "mixed_70pct",
        "mixed_lat50_analytic", "mixed_lat50_measured"]),
}


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    """The bench model at 2 layers of TINY_WIDTHS, 2 training steps, 2
    iterations a unit (1 for AdaQuant), 2 QAT steps, 5 GA generations; one
    cache directory for the module, so later tables reuse earlier
    calibrations as in a real run."""
    art = tmp_path_factory.mktemp("bench_torch")
    small = dataclasses.replace(common.bench_config(), n_layers=2, **TINY_WIDTHS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ART", art)
        mp.setattr(common, "bench_config", lambda: small)
        mp.setattr(common, "TRAIN_STEPS", 2)
        mp.setattr(table4_cost, "QAT_STEPS", 2)
        for mod in (common, table4_cost):
            mp.setattr(mod, "BATCH", TINY_BATCH)
            mp.setattr(mod, "SEQ", TINY_SEQ)
        mp.setattr(common, "N_CALIB", TINY_CALIB)
        for mod, _ in TABLE_ROWS.values():
            mp.setattr(mod, "RECON_ITERS", TINY_ITERS)
        # fig2's genetic searches at 5 generations (100 in the table)
        mp.setattr(fig2_mixed_precision, "GAConfig",
                   lambda **kw: GAConfig(**{**kw, "iters": 5}))
        yield art


@pytest.mark.parametrize("table", list(TABLE_ROWS))
def test_table_runs_on_the_cpu(tiny_bench, table):
    mod, names = TABLE_ROWS[table]
    rows = mod.main(device="cpu")
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert np.isfinite(r["us_per_call"]), r
        for k in ("loss", "top1", "calib_iters_per_s"):
            if k in r:
                assert np.isfinite(r[k]), r
    short = {"fig2_mixed_precision": "fig2"}.get(table, table.split("_")[0])
    assert (tiny_bench / f"{short}.json").is_file()


def test_run_prints_each_table_and_skips_roofline(tiny_bench, capsys):
    from benchmarks_torch import run

    run.main(["table1_granularity", "roofline_table", "--device", "cpu"])
    out = capsys.readouterr().out
    # the roofline table reads the dry run's artifacts (none here: it says so)
    assert "===== roofline_table done in" in out and "roofline/" in out
    assert "table1/block_w2," in out
    assert "===== table1_granularity done in" in out and "FAILED" not in out
    assert "'fakequant': 0" in out  # the CPU runs the plain paths


def test_bench_modules_import_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import benchmarks_torch\n"
        "for m in pkgutil.walk_packages(benchmarks_torch.__path__, 'benchmarks_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
