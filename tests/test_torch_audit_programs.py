"""The port's program audit (``repro_torch.analysis.audit``) on the CPU.

The reference's four program rules, their eager counterparts here:
``donation_respected`` (donated arguments written in place),
``no_host_transfer`` (no op synchronises with the host) and
``stable_compile_cache`` (a same-structure second call builds nothing), each
driven to fire by a seeded fault, as ``tests/test_audit.py`` drives the
reference's, and a calibration whose unit-cache key is broken. The port's
``build_programs`` gives the program names that the reference's builders
give, in their order, and its quick set, calibration included, has no
violation but the one documented suppression, as the reference's is clean
(``tests/test_audit.py::test_real_qmm_programs_clean``; the reference's
builders cost about 25 s here, and its XLA rules and calibration as much
again, so its violations are not recomputed).
``scripts/run_audit_torch.py --family program`` exits 0, and 1 on a seeded
violation.
"""
import ast
import dataclasses
import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from repro.analysis.audit import program_check as jpc
from repro_torch.analysis.audit import program_check as pc
from repro_torch.analysis.audit.rules import (PROGRAM_RULES, AuditProgram,
                                              registered_rules, run_program_rules)
from repro_torch.core import calib_loop
from repro_torch.kernels import spec
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _jax_capture_tags() -> set:
    """The tags the reference's ``calib_loop`` hands ``AUDIT_CAPTURE``; its
    ``calib_audit`` names each captured program ``calib_<tag>``."""
    from repro.core import calib_loop as jcl

    return {n.args[0].elts[0].value for n in ast.walk(ast.parse(inspect.getsource(jcl)))
            if isinstance(n, ast.Call) and ast.unparse(n.func) == "AUDIT_CAPTURE.append"}


@pytest.fixture(scope="module")
def quick():
    return pc.build_programs("quick", with_calib=True, device="cpu")


@pytest.fixture(scope="module")
def jax_names():
    """The reference's quick program names, in its order, from its own
    builders (its calibration programs need a JAX ``quantize``: their tags
    are read from its ``calib_loop``)."""
    progs, viol = jpc.build_programs("quick", with_calib=False)
    assert viol == []
    return [p.name for p in progs]


def test_program_names_match_jax(quick, jax_names):
    progs, builder_viol = quick
    assert (pc.QUICK_ARCHS, pc.EXTRA_ARCHS) == (jpc.QUICK_ARCHS, jpc.EXTRA_ARCHS)
    names = [p.name for p in progs]
    assert names[:-1] == jax_names and len(jax_names) == 10
    assert names[-1] == "calib_unit_scan" and "unit_scan" in _jax_capture_tags()
    assert builder_viol == []
    assert set(PROGRAM_RULES) == {r.name for r in registered_rules("program")}
    decode = {p.name: p for p in progs}
    for name in ("serve_decode[brecq_lm_100m]", "budget_decode[brecq_lm_100m]",
                 "engine_decode[brecq_lm_100m]"):
        assert decode[name].donate_argnums == (2,) and decode[name].repeat_args
    assert decode["calib_unit_scan"].donate_argnums == calib_loop.UNIT_DONATE == (2, 3)


def test_quick_programs_clean_like_jax(quick):
    """Every rule on every program; the only rule not applied is a documented
    suppression, with a reason that names the op and its lines."""
    progs, _ = quick
    log, skipped = [], []
    assert run_program_rules(progs, verbose=log.append, skipped=skipped) == []
    suppressed = {(p.name, r): why for p in progs for r, why in p.suppress.items()}
    assert set(suppressed) == {("calib_unit_scan", "donation_respected")}
    for (name, rule), why in suppressed.items():
        assert (name, rule) in skipped
        assert any(f"suppressed {rule} on {name}: {why}" in s for s in log)
        assert "adam.py:" in why and "calib_loop.py:" in why and "ROADMAP 16" in why
    ran = [(p.name, r) for p in progs for r in PROGRAM_RULES if (p.name, r) not in skipped]
    assert len(ran) >= 30


def test_seeded_dropped_donation_fires():
    """A decode that writes a copy of its cache and returns the copy keeps
    nothing of the donated cache."""
    cache = {"k": torch.zeros(2, 512, 4, 64), "v": torch.zeros(2, 512, 4, 64)}

    def decode(x, c):
        c = {k: t.clone() for k, t in c.items()}
        c["k"][:, 0] = x
        return x.sum(), c

    prog = AuditProgram(name="seeded_drop", fn=decode, args=(torch.ones(4, 64), cache),
                        donate_argnums=(1,))
    found = run_program_rules([prog], rules=("donation_respected",))
    assert found and {v.rule for v in found} == {"donation_respected"}
    msgs = " ".join(v.message for v in found)
    assert "returns new tensors for 2/2" in msgs
    assert "'clone' made 2 new (2, 512, 4, 64)" in msgs  # 1 MiB each: second copies

    def replaced(x, c):  # the argument's leaf swapped for a new tensor
        c["k"] = c["k"] + 0.0
        return x, c

    prog = dataclasses.replace(prog, name="seeded_swap", fn=replaced)
    found = run_program_rules([prog], rules=("donation_respected",))
    assert any("1/2 of its tensors were replaced" in v.message for v in found)


def test_donation_respected_on_honored_donation():
    """Sanity: a cache written in place and handed back passes."""
    cache = {"k": torch.zeros(2, 512, 4, 64), "v": torch.zeros(2, 512, 4, 64)}

    def decode(x, c):
        c["k"][:, 0] = x
        c["v"].add_(1.0)
        return x.sum(), c

    prog = AuditProgram(name="honored", fn=decode, args=(torch.ones(4, 64), cache),
                        donate_argnums=(1,))
    assert run_program_rules([prog], rules=("donation_respected",)) == []


@pytest.mark.parametrize("how,op", [
    ("item", "aten._local_scalar_dense"), ("tolist", "Tensor.tolist"),
    ("nonzero", "aten.nonzero"), ("repeat_interleave", "aten.repeat_interleave")])
def test_seeded_host_callback_fires(how, op):
    """A hot program that reads a device value on the host trips
    no_host_transfer, naming the op and its count a call; the same program
    without the read passes."""

    def f(x):
        y = x * 2
        if how == "item":
            y = y + y.sum().item()
        elif how == "tolist":
            y = y + sum(y[:2].tolist())
        elif how == "nonzero":
            y = y[torch.nonzero(y > 0)[:, 0]]
        else:
            y = torch.repeat_interleave(y, torch.tensor([1, 2, 1, 2]), dim=0)
        return y + 1

    prog = AuditProgram(name="seeded_callback", fn=f, args=(torch.ones(4),))
    found = run_program_rules([prog], rules=("no_host_transfer",))
    assert found and found[0].rule == "no_host_transfer"
    assert f"op {op!r} x" in found[0].message and "a call" in found[0].message
    clean = AuditProgram(name="clean", fn=lambda x: x * 2 + 1, args=(torch.ones(4),))
    assert run_program_rules([clean], rules=("no_host_transfer",)) == []


def test_seeded_retrace_fires():
    """A program whose launch-plan key holds an object's id plans again on
    a same-structure second call: stable_compile_cache reports the growth."""

    def f(x):
        spec.plan_kv_decode(1, 1, id(x), 64)
        return x * 2

    prog = AuditProgram(name="seeded_retrace", fn=f, args=(torch.ones(4),),
                        repeat_args=(torch.ones(4),))
    found = run_program_rules([prog], rules=("stable_compile_cache",))
    assert found and "spec.plan_kv_decode" in found[0].message and " -> " in found[0].message
    stable = dataclasses.replace(prog, name="stable",
                                 fn=lambda x: (spec.plan_kv_decode(1, 1, 4096, 64), x)[1])
    assert run_program_rules([stable], rules=("stable_compile_cache",)) == []


def test_suppression_skips_rule_and_is_surfaced():
    def f(x):
        spec.plan_kv_decode(1, 1, id(x), 64)
        return x * 2

    prog = AuditProgram(name="suppressed", fn=f, args=(torch.ones(4),),
                        repeat_args=(torch.ones(4),),
                        suppress={"stable_compile_cache": "intentional plan probe"})
    log, skipped = [], []
    assert run_program_rules([prog], rules=("stable_compile_cache",), verbose=log.append,
                             skipped=skipped) == []
    assert any("intentional plan probe" in s for s in log)
    assert skipped == [("suppressed", "stable_compile_cache")]


def test_broken_unit_cache_key_fires(monkeypatch):
    """A unit-program cache key that holds something new on every call
    leaves the second identical block without a hit: calib_audit reports it."""
    keys = iter(range(10**6))
    orig = calib_loop.unit_cache_key
    monkeypatch.setattr(calib_loop, "unit_cache_key",
                        lambda *a: orig(*a) + (next(keys),))
    progs, found = pc.calib_audit(n_layers=2, iters=2, device="cpu")
    assert [p.name for p in progs] == ["calib_unit_scan"]
    assert len(found) == 1 and found[0].rule == "stable_compile_cache"
    assert "only 0 unit-program cache hit(s)" in found[0].message
    monkeypatch.undo()
    assert pc.calib_audit(n_layers=2, iters=2, device="cpu")[1] == []


def test_audit_capture_changes_no_result():
    """quantize() with AUDIT_CAPTURE installed gives the logits and params it
    gives without, bit for bit, and the captured program reruns."""
    import dataclasses as dc

    from repro_torch.core import ReconConfig, quantize
    from repro_torch.data import Corpus, CorpusConfig, make_batches
    from repro_torch.models import build_model, get_config

    cfg = dc.replace(get_config("brecq_lm_100m", reduced=True), n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calib = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1)
    rc = ReconConfig(w_bits=4, iters=3, calib_bs=4, seed=0)
    ref = quantize(model, params, calib, rc)
    captured = []
    calib_loop.AUDIT_CAPTURE = captured
    try:
        res = quantize(model, params, calib, rc)
    finally:
        calib_loop.AUDIT_CAPTURE = None
    assert [c[0] for c in captured] == ["unit_scan"] * 2
    for p in ref.v:
        assert torch.equal(res.v[p], ref.v[p]), p
    tag, program, args, walker = captured[0]
    assert walker is not None and len(program(*args)[2]) == 3


def _audit_main(capsys, *args) -> tuple[int, str]:
    spec_ = importlib.util.spec_from_file_location(
        "run_audit_torch", ROOT / "scripts" / "run_audit_torch.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    capsys.readouterr()
    rc = mod.main(list(args))
    return rc, capsys.readouterr().out


def test_cli_program_family(capsys, monkeypatch):
    """``--family program --configs quick --device cpu`` exits 0 and prints
    each suppression with its reason; a seeded violation exits 1."""
    rc, out = _audit_main(capsys, "--family", "program", "--configs", "quick",
                          "--device", "cpu")
    assert rc == 0, out
    assert "audit clean" in out and "11 programs" in out
    assert "suppressed donation_respected on calib_unit_scan: optim/adam.py" in out

    real = pc.build_programs

    def with_fault(*a, **k):
        progs, viol = real(*a, **k)
        bad = AuditProgram(name="seeded_sync", fn=lambda x: x + x.sum().item(),
                           args=(torch.ones(4),))
        return progs + [bad], viol

    monkeypatch.setattr(pc, "build_programs", with_fault)
    rc, out = _audit_main(capsys, "--family", "program", "--no-calib", "--device", "cpu")
    assert rc == 1, out
    assert "AUDIT FAILED: 1 violation(s)" in out and "seeded_sync" in out
