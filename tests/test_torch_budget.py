"""The port's budgeted deployment (``deploy/budget/``, ``serve
--budget-*``) against the JAX package, on the CPU.

The solver, the group reduction, the brute-force oracle and the bytes
table are pure Python/numpy: equal exactly on seeded problems. The RTN
proxy sensitivity within 1e-6 relative (f32 sums in another order). The
mixed artifacts: the same assignment, byte-identical checksums and
digest, loading verified in both packages. The measured cost table and
its dispatch on the CPU (the plain tiers); the card's CUDA tiers are
held in ``tests/test_torch_cuda.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.sensitivity import SensTable as JSensTable
from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import budget as jb
from repro.models import get_model as j_get_model
from repro_torch.core.sensitivity import SensTable
from repro_torch.deploy import QuantizedArtifact
from repro_torch.deploy import budget as tb
from repro_torch.interop import params_from_numpy

BITS = (2, 4, 8)


def random_problem(seed, n_max=6):
    """A seeded solver problem as JSON docs (the JAX budget tests' draw):
    a sensitivity table, a cost table, optional groups and a budget."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, n_max + 1))
    paths = [f"l{i}" for i in range(n)]
    block_of = {p: int(rng.integers(0, 2)) for p in paths}
    diag = []
    for p in paths:
        vals = sorted(rng.uniform(0.0, 10.0, len(BITS)), reverse=True)
        diag += [[p, b, float(v)] for b, v in zip(BITS, vals)]
    offdiag = []
    for i in range(n):
        for j in range(i + 1, n):
            if block_of[paths[i]] == block_of[paths[j]] and rng.random() < 0.4:
                offdiag.append([paths[i], paths[j], float(rng.uniform(-1.0, 2.0))])
    sens = {"diag": diag, "offdiag": offdiag, "block_of": block_of,
            "shapes": {p: [8, 8] for p in paths}}
    costs = [[p, b, float(rng.uniform(0.1, 1.0)) * b] for p in paths for b in BITS]
    table = {"kind": "bytes", "backend": "test", "costs": costs}
    groups = None
    if rng.random() < 0.5:
        groups = {p: f"g{int(rng.integers(0, 2))}" if rng.random() < 0.6 else p
                  for p in paths}
    lo = sum(min(c for q, _, c in costs if q == p) for p in paths)
    hi = sum(max(c for q, _, c in costs if q == p) for p in paths)
    return sens, table, groups, float(lo + rng.uniform(0.0, 1.0) * (hi - lo))


def both(sens_doc, table_doc):
    return ((JSensTable.from_json(sens_doc), jb.CostTable.from_json(table_doc)),
            (SensTable.from_json(sens_doc), tb.CostTable.from_json(table_doc)))


def solve_both(fn_name, sens_doc, table_doc, *args, **kw):
    """``fn_name`` of both packages on the same problem: (port, jax), or
    the exception type each raised."""
    (js, jt), (ts, tt) = both(sens_doc, table_doc)
    out = []
    for mod, s, t in ((tb, ts, tt), (jb, js, jt)):
        try:
            out.append(getattr(mod, fn_name)(s, t, *args, **kw))
        except (tb.BudgetInfeasibleError, jb.BudgetInfeasibleError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("seed", range(16))
def test_solver_matches_jax(seed):
    sens, table, groups, budget = random_problem(seed)
    for method in ("exact", "lagrange"):
        for g in (None, groups):
            got, want = solve_both("solve_budget", sens, table, budget, groups=g,
                                   method=method)
            if isinstance(want, str):
                assert got == want == "BudgetInfeasibleError"
                continue
            assert got.assign == want.assign and got.to_json() == want.to_json()
            assert got.cost <= budget + 1e-9
    got, want = solve_both("brute_force", sens, table, budget, groups=groups)
    assert (got == want) if isinstance(want, str) else (
        got.assign == want.assign and got.predicted_loss == want.predicted_loss)
    if not isinstance(want, str):
        exact = solve_both("solve_budget", sens, table, budget, groups=groups)[0]
        assert exact.predicted_loss == pytest.approx(got.predicted_loss, abs=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_grouped_problem_matches_jax(seed):
    sens, table, groups, _ = random_problem(seed)
    groups = groups or {p: "g" for p in sens["shapes"]}
    (js, jt), (ts, tt) = both(sens, table)
    gs, gc, expand = tb.grouped_problem(ts, tt, groups)
    jgs, jgc, jexpand = jb.grouped_problem(js, jt, groups)
    assert gs.to_json() == jgs.to_json() and gc.to_json() == jgc.to_json()
    assign = {p: BITS[i % 3] for i, p in enumerate(sorted(gs.shapes))}
    assert expand(assign) == jexpand(assign)


def test_infeasible_budget_raises_in_both():
    sens, table, _, _ = random_problem(0)
    got, want = solve_both("solve_budget", sens, table, 1e-3)
    assert got == want == "BudgetInfeasibleError"


def test_bytes_cost_table_matches_jax():
    shapes = {"body.0/a": (768, 768), "body.0/b": (770, 96), "body.0/c": (6, 64),
              "moe.0/e": (64, 2048, 1408)}
    got = tb.bytes_cost_table(shapes, (2, 3, 4, 8))
    want = jb.bytes_cost_table(shapes, (2, 3, 4, 8))
    assert got.to_json() == want.to_json()
    assert got.cost("body.0/b", 2) == 770 * 96  # 770 rows do not pack 4 a byte
    assert got.cost("body.0/b", 4) == 770 * 96 / 2
    assert got.cost("moe.0/e", 2) == 64 * 2048 * 1408 / 4


# ---------------------------------------------------------------------------
# artifacts on reduced models
# ---------------------------------------------------------------------------


def assert_same_solve(got: dict, want: dict) -> None:
    """Two manifests' ``budget`` records: equal, the predicted loss (a sum
    of the proxy's f32 sums) within 1e-6 relative."""
    got, want = dict(got), dict(want)
    np.testing.assert_allclose(got.pop("predicted_loss"), want.pop("predicted_loss"),
                               rtol=1e-6)
    assert got == want


@pytest.fixture(scope="module", params=["brecq_lm_100m", "deepseek_moe_16b"])
def reduced(request):
    """A reduced model's random weights in both packages; ``n`` is the
    layer count the stacks are filtered by (None: every stack, as the MoE
    model's dense0 and moe stacks differ in depth)."""
    cfg, jmodel = j_get_model(request.param, reduced=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    n = cfg.n_layers if cfg.family == "dense" else None
    return cfg, jparams, params, n


def test_weight_sens_table_matches_jax(reduced):
    cfg, jparams, params, n = reduced
    got, want = tb.weight_sens_table(params, n), jb.weight_sens_table(jparams, n)
    assert got.shapes == want.shapes and got.block_of == want.block_of
    assert list(got.diag) == list(want.diag) and got.offdiag == want.offdiag == {}
    for k, v in want.diag.items():
        np.testing.assert_allclose(got.diag[k], v, rtol=1e-6)
    assert tb.weight_shapes(params, n) == jb.weight_shapes(jparams, n)
    assert tb.storage_groups(got.shapes) == jb.storage_groups(want.shapes)


def test_rtn_mixed_artifact_matches_jax(reduced, tmp_path):
    cfg, jparams, params, n = reduced
    shapes = tb.weight_shapes(params, n)
    rng = np.random.default_rng(0)
    assign = {p: int(rng.choice(BITS)) for p in shapes}
    got = tb.rtn_mixed_artifact(params, assign, cfg=cfg)
    want = jb.rtn_mixed_artifact(jparams, assign, cfg=cfg)
    assert got.manifest["bits_by_path"] == want.manifest["bits_by_path"]
    assert got.stats["bits_histogram"] == want.stats["bits_histogram"]
    assert got.nbytes() == want.nbytes()
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "jax"))
    assert got.manifest["checksums"] == want.manifest["checksums"]
    assert got.manifest["content_digest"] == want.manifest["content_digest"]
    # each package loads the other's, verified
    JArtifact.load(str(tmp_path / "port"))
    back = QuantizedArtifact.load(str(tmp_path / "jax"))
    assert back.manifest["content_digest"] == got.manifest["content_digest"]


def test_budget_artifact_bytes_matches_jax(reduced, tmp_path):
    cfg, jparams, params, n = reduced
    sens = tb.weight_sens_table(params, n)
    lo = tb.rtn_mixed_artifact(params, {p: 2 for p in sens.shapes}, cfg=cfg).nbytes()
    hi = tb.rtn_mixed_artifact(params, {p: 8 for p in sens.shapes}, cfg=cfg).nbytes()
    budget = (lo + hi) // 2
    art, sol, table = tb.budget_artifact(params, sens, budget, kind="bytes", cfg=cfg)
    jart, jsol, jtable = jb.budget_artifact(jparams, jb.weight_sens_table(jparams, n),
                                            budget, kind="bytes", cfg=cfg)
    assert sol.assign == jsol.assign and len(set(sol.assign.values())) > 1
    assert table.to_json() == jtable.to_json()
    assert art.nbytes() == jart.nbytes() <= budget
    assert_same_solve(art.manifest["budget"], jart.manifest["budget"])
    art.save(str(tmp_path / "port"))
    jart.save(str(tmp_path / "jax"))
    assert art.manifest["content_digest"] == jart.manifest["content_digest"]
    assert JArtifact.load(str(tmp_path / "port")).nbytes() == art.nbytes()
    with pytest.raises(tb.BudgetInfeasibleError, match="fixed bytes"):
        tb.budget_artifact(params, sens, lo // 2, kind="bytes", cfg=cfg)


# ---------------------------------------------------------------------------
# measured cost tables and dispatch (plain tiers on the CPU)
# ---------------------------------------------------------------------------


def test_measured_cost_table_and_dispatch(monkeypatch):
    from repro_torch.kernels.qmatmul import ops as qmm_ops

    monkeypatch.delenv("REPRO_QMM_DISPATCH", raising=False)
    shapes = {"a": (64, 32), "b": (64, 32), "c": (2, 32, 16)}
    qmm_ops.reset_tier_counts()
    table = tb.measure_cost_table(shapes, m=1, inner=2, reps=1, device="cpu")
    assert table.backend == "cpu" and table.meta["device_name"] == "cpu"
    for p in shapes:
        for b in BITS:
            assert table.cost(p, b) > 0
    # identical (shape, container) rows share one measurement
    assert table.cost("a", 4) == table.cost("b", 4)
    # grouped stacks time the grouped tier only
    assert table.tiers[("c", 4)] == "grouped"
    assert table.meta["m"] == 1 and table.meta["unique_shapes"] == 6
    # each timing: 1 warm-up + reps x inner calls
    assert qmm_ops.TIER_COUNTS == {"decode": 9, "prefill": 9, "grouped": 9}
    assert tb.CostTable.from_json(table.to_json()) == table
    try:
        tb.install_dispatch(table)
        assert qmm_ops._DISPATCH_TABLE
        assert all(isinstance(k, tuple) and len(k) == 3 for k in qmm_ops._DISPATCH_TABLE)
        assert qmm_ops.dispatch_mode() == "measured"
        # an installed table is set aside while measuring
        tb.measure_cost_table({"a": (64, 32)}, m=1, inner=1, reps=1, device="cpu")
        assert qmm_ops._DISPATCH_TABLE
    finally:
        tb.install_dispatch(None)
    assert qmm_ops.dispatch_mode() == "heuristic"


def test_ensure_cost_table_caches_in_manifest():
    cfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                               device="cpu")
    shapes = tb.weight_shapes(params, cfg.n_layers)
    art = tb.rtn_mixed_artifact(params, {p: 4 for p in shapes}, cfg=cfg)
    two = dict(list(shapes.items())[:2])
    t1 = tb.ensure_cost_table(art, two, m=1, inner=2, reps=1, device="cpu")
    assert art.manifest["cost_tables"]["cpu"]["meta"]["m"] == 1
    assert tb.ensure_cost_table(art, two, m=1, inner=2, reps=1, device="cpu") == t1
    assert tb.ensure_cost_table(art, two, m=4, inner=2, reps=1, device="cpu").meta["m"] == 4


def test_serve_budget_bytes_matches_jax(tmp_path, monkeypatch):
    """serve --budget-bytes B: the same solved artifact as the JAX CLI's
    (digest), nbytes <= B, and the same greedy tokens."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    monkeypatch.delenv("REPRO_QMM_DISPATCH", raising=False)
    cfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    sens = tb.weight_sens_table(params, cfg.n_layers)
    lo = tb.rtn_mixed_artifact(params, {p: 2 for p in sens.shapes}, cfg=cfg).nbytes()
    hi = tb.rtn_mixed_artifact(params, {p: 8 for p in sens.shapes}, cfg=cfg).nbytes()
    budget = (lo + hi) // 2
    argv = ["--reduced", "--budget-bytes", str(budget), "--batch", "2",
            "--prompt-len", "8", "--gen-len", "4", "--no-compare-fp"]
    want = jserve.main(argv + ["--save-artifact", str(tmp_path / "jax")], params=jparams)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = serve.main(argv + ["--save-artifact", str(tmp_path / "port"), "--device",
                                 "cpu"], params=params)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(want))
    art = QuantizedArtifact.load(str(tmp_path / "port"))
    jart = JArtifact.load(str(tmp_path / "jax"))
    assert out["artifact_bytes"] == art.nbytes() == jart.nbytes() <= budget
    assert art.manifest["content_digest"] == jart.manifest["content_digest"]
    assert_same_solve(art.manifest["budget"], jart.manifest["budget"])
