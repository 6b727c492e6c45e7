"""The port's analysis layer (``repro_torch.analysis``) on the CPU.

The roofline's ``estimate_params``, ``active_params``, ``model_flops`` and
``ideal_serve_bytes`` against the JAX package's for all 11 configs at every
shape (counts exact, floats within 1e-12 relative); ``estimate_params``
under ``FakeTensorMode`` allocates nothing; the constants are the H100's.
The kernel audit sweeps every registered config clean at W2, W4 and W8,
and a seeded bad leaf and a cut shared-memory budget fire its two rules.
The AST lints fire on seeded offenders, honour the suppression comment and
pass on the port's own sources; ``no_materialized_f32_weight`` fires on a
seeded full dequant of a stacked leaf and passes on the three qmm tiers;
``scripts/run_audit_torch.py`` exits 0 and 1 as it should.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import roofline as jroof
from repro.configs.base import SHAPES as JSHAPES
from repro.dist.sharding import estimate_params as j_estimate_params
from repro.models import get_config as j_get_config
from repro_torch.analysis import roofline
from repro_torch.analysis.audit import ast_lint, kernel_check
from repro_torch.analysis.audit.program_check import (forbidden_f32_shapes,
                                                      qmm_programs)
from repro_torch.analysis.audit.rules import (AuditProgram, Violation,
                                              registered_rules, run_program_rules)
from repro_torch.configs.base import SHAPES
from repro_torch.dist.sharding import estimate_params
from repro_torch.kernels import spec
from repro_torch.models import ARCH_IDS, get_config
from torch_threads import one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_terms_match_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert estimate_params(cfg) == j_estimate_params(jcfg)
    assert roofline.active_params(cfg) == jroof.active_params(jcfg)
    assert set(SHAPES) == set(JSHAPES)
    for name in SHAPES:
        for n_chips in (1, 4):
            for got, want in (
                    (roofline.model_flops(cfg, SHAPES[name], n_chips),
                     jroof.model_flops(jcfg, JSHAPES[name], n_chips)),
                    *((roofline.ideal_serve_bytes(cfg, SHAPES[name], n_chips, w),
                       jroof.ideal_serve_bytes(jcfg, JSHAPES[name], n_chips, w))
                      for w in (4, 16))):
                assert got == pytest.approx(want, rel=1e-12, abs=0), (name, n_chips)


def test_estimate_params_allocates_nothing():
    """llama-3.2-vision-90b at full width (≈ 350 GB of f32) is counted with
    the process's peak RSS growing by less than 1 GB."""
    code = (
        "import resource\n"
        "from repro_torch.dist.sharding import estimate_params\n"
        "from repro_torch.models import get_config\n"
        "cfg = get_config('llama32_vision_90b')\n"
        "before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "n = estimate_params(cfg)\n"
        "after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "print(n, (after - before) * 1024)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n, grown = (float(x) for x in res.stdout.split())
    assert n > 8e10 and n * 4 > 300e9
    assert grown < 1e9


def test_roofline_constants_are_the_h100s():
    assert (roofline.HBM_BW, roofline.PEAK_FLOPS, roofline.PEAK_TF32,
            roofline.PEAK_F32) == (3.35e12, 989e12, 495e12, 67e12)
    assert roofline.LINK_BW == 450e9
    assert (roofline.HBM_BW, roofline.PEAK_FLOPS) != (jroof.HBM_BW, jroof.PEAK_FLOPS)
    assert not hasattr(roofline, "ICI_BW")
    with pytest.raises(NotImplementedError, match="15c/15d"):
        roofline.from_hlo("", get_config("brecq_lm_100m"), SHAPES["decode_32k"], 1)


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_registered_configs_sweep_clean(bits):
    """Every launch the port's dispatch would issue over the 11 registered
    configs at full width keeps its contract and fits the shared memory of
    a block."""
    got = kernel_check.run_kernel_checks(ARCH_IDS, bits=bits)
    assert got == [], [str(v) for v in got]


def test_kernel_sweep_flags_bad_leaf():
    out = []
    kernel_check._sweep_leaf("fake_arch", "body/w", 100, (40, 128), (1, 128),
                             lambda r, s, m: out.append(Violation(r, s, m)))
    assert [v.rule for v in out] == ["kernel_tile_divisibility"]
    out = []  # scale groups that do not divide K: the contract names them
    kernel_check._sweep_leaf("fake_arch", "body/w", 256, (128, 128), (3, 128),
                             lambda r, s, m: out.append(Violation(r, s, m)))
    assert out and {v.rule for v in out} == {"kernel_tile_divisibility"}


def _clear_plans():
    for plan in (spec.plan_qgemv, spec.plan_qmatmul, spec.plan_kv_decode):
        plan.cache_clear()


def test_cut_shared_memory_fires_smem_budget(monkeypatch):
    _clear_plans()  # the plans are cached; each must test the cut budget
    monkeypatch.setattr(spec, "SMEM_PER_BLOCK", 4096)
    try:
        got = kernel_check.audit_arch("brecq_lm_100m")
    finally:
        _clear_plans()
    rules = {v.rule for v in got}
    assert rules == {"kernel_smem_budget"}
    subjects = {v.subject.split("[")[-1] for v in got}
    assert {"decode]", "prefill]"} <= subjects
    assert any(v.subject.endswith("kv_decode_paged") for v in got)


BAD_SOURCE = '''

def capture(g, x):
    with torch.cuda.graph(g):
        y = x * 2
        n = y.sum().item()
        torch.cuda.synchronize()
    return n

def bad_default(xs=[]):
    return xs

def kern(x, backend="torch"):
    assert x.ndim == 2
    return x

def fine(x, backend="torch"):  # audit: ignore[no_plain_backend_default]
    return x
'''


def test_seeded_ast_offenders_fire(tmp_path):
    pkg = tmp_path / "kernels"
    pkg.mkdir()
    (pkg / "bad.py").write_text(BAD_SOURCE)
    got = ast_lint.run_ast_lint(tmp_path)
    assert {v.rule for v in got} == {"no_host_sync_in_graph", "no_mutable_default_arg",
                                     "no_bare_assert_in_kernels",
                                     "no_plain_backend_default"}
    assert sum(v.rule == "no_host_sync_in_graph" for v in got) == 2
    assert sum(v.rule == "no_plain_backend_default" for v in got) == 1


def test_ast_suppression_comment(tmp_path):
    (tmp_path / "s.py").write_text(
        "def f(xs=[]):  # audit: ignore[no_mutable_default_arg]\n"
        "    return xs\n")
    assert ast_lint.run_ast_lint(tmp_path) == []


def test_kernel_rules_only_under_kernels(tmp_path):
    """Bare asserts and a plain backend default are lints under kernels/
    only; a host sync outside a capture is no finding."""
    (tmp_path / "other.py").write_text(
        "def f(x, backend='torch'):\n    assert x\n    return x.item()\n")
    assert ast_lint.run_ast_lint(tmp_path) == []


@pytest.mark.parametrize("tree", ("src/repro_torch", "benchmarks_torch"))
def test_port_tree_lints_clean(tree):
    got = ast_lint.run_ast_lint(ROOT / tree)
    assert got == [], [str(v) for v in got]


def test_seeded_f32_dequant_fires():
    """A full dequant of a stacked leaf is caught; the three qmm tiers on
    the plain path are clean."""
    progs = qmm_programs("cpu")
    node3 = {"w": progs[2].args[1], "qscale": progs[2].args[2]}
    shapes = forbidden_f32_shapes({"n": node3})
    assert (4, 64, 128) in shapes and all(len(s) == 3 for s in shapes)

    def dequant_all(x, w, qs):  # unpacks every expert at once
        from repro_torch.kernels.qmatmul.ref import qmm_grouped_dense_ref

        return qmm_grouped_dense_ref(x, w, qs, 4)

    bad = AuditProgram("full_dequant", dequant_all, progs[2].args, forbidden_f32=shapes)
    got = run_program_rules([bad])
    assert got and {v.rule for v in got} == {"no_materialized_f32_weight"}
    assert any("(4, 64, 128)" in v.message for v in got)
    skipped = []
    assert run_program_rules(progs, skipped=skipped) == []
    assert skipped == [("qmm_decode", "no_materialized_f32_weight"),
                       ("qmm_prefill", "no_materialized_f32_weight")]


def _audit_main(capsys, *args) -> tuple[int, str]:
    """``scripts/run_audit_torch.py``'s ``main`` in this process: (exit
    code, standard output)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_audit_torch", ROOT / "scripts" / "run_audit_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    rc = mod.main(list(args))
    return rc, capsys.readouterr().out


def test_run_audit_cli_ast_family_clean(capsys):
    rc, out = _audit_main(capsys, "--family", "ast")
    assert rc == 0, out
    assert "audit clean" in out


def test_run_audit_cli_exits_nonzero_on_violation(tmp_path):
    """The script itself, in a process of its own: exit code 1."""
    pkg = tmp_path / "kernels"
    pkg.mkdir()
    (pkg / "bad.py").write_text(BAD_SOURCE)
    p = subprocess.run([sys.executable, str(ROOT / "scripts" / "run_audit_torch.py"),
                        "--family", "ast", "--src", str(tmp_path)],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "AUDIT FAILED" in p.stdout and "no_plain_backend_default" in p.stdout


def test_run_audit_cli_lists_rules(capsys):
    rc, out = _audit_main(capsys, "--list-rules")
    assert rc == 0
    names = {"no_materialized_f32_weight", "donation_respected", "no_host_transfer",
             "stable_compile_cache", "kernel_tile_divisibility",
             "kernel_smem_budget", "no_host_sync_in_graph", "no_mutable_default_arg",
             "no_bare_assert_in_kernels", "no_plain_backend_default"}
    listed = {line.split()[1] for line in out.splitlines() if line.strip()}
    assert listed == names == {r.name for r in registered_rules()}
