"""Nothing under perfbench/ loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
plain reference loads nothing of the port."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PKG = harness.PKG
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports(path):
    mods = _imports(path)
    assert not mods & set(harness.FORBIDDEN_MODULES), mods
    if "reference" in path.parts:
        assert "repro_torch" not in mods, mods


def test_forbidden_is_whole_name():
    assert harness.forbidden_loaded(["repro_torch.models", "jaxtyping", "reproducible"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "repro.core", "flax"]) == [
        "flax", "jax.numpy", "repro.core"]


def test_loaded_in_a_subprocess():
    """Import the harness, every driver, reader and reference, and the
    port modules the drivers reach, in a clean interpreter."""
    code = (
        "import sys, json\n"
        "from perfbench import harness, run, trace, traffic, weights, port\n"
        "import perfbench.reference.model, perfbench.reference.calib\n"
        "for d in ('serve', 'calib'): harness.load_driver(d)\n"
        "for m in harness.load_spec()['per_layer']: harness.load_metric(m['name'])\n"
        "import repro_torch.serve_engine.engine, repro_torch.core.reconstruction\n"
        "import repro_torch.deploy, repro_torch.ckpt.checkpoint\n"
        "print(json.dumps(harness.forbidden_loaded(sys.modules)))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(harness.ROOT / "src"), str(harness.ROOT)])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=harness.ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_reference_without_port():
    """The reference modules import in an interpreter that cannot see the port."""
    code = ("import sys\n"
            "import perfbench.reference.model, perfbench.reference.calib\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch']\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(harness.ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=harness.ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
