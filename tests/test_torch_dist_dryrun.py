"""The port's dry run (``repro_torch.launch.dryrun``) on the ``fake`` backend.

One subprocess (the fake process group never joins the pytest worker) runs
the reduced cells of the JAX package's dry-run tests: tinyllama-1.1b's
``decode_32k`` with ``--quant 4 --group 64`` on the 8-rank (4, 2) mesh
(``test_dryrun_reduced_quant_decode_cell``), and deepseek-moe-16b's
``decode_32k`` on the (2, 2, 2) pod x data x model mesh
(``test_dryrun_reduced_multi_mesh``; its train cell takes over 30 s of
DTensor propagation on this CPU and stays out of this test). Each artifact's
argument bytes per rank, read off the fake DTensors' local shards, equal
the sum of JAX's ``NamedSharding(...).shard_shape`` bytes over the same
trees on ``AbstractMesh``, argument by argument; FLOPs, collectives and the
fit verdict are there; ``benchmarks_torch.roofline_table`` reads the
directory.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import deploy as jdeploy
from repro.configs.base import SHAPES
from repro.dist.sharding import Plan as JPlan
from repro.dist.sharding import pick_strategy as j_pick_strategy
from repro.models import get_model as j_get_model

SRC = str(Path(__file__).resolve().parents[1] / "src")
CELLS = [("tinyllama_1_1b", "decode_32k", "single", ["--quant", "4", "--group", "64",
                                                      "--tag", "w4"]),
         ("deepseek_moe_16b", "decode_32k", "multi", [])]
MESHES = {"single": ((4, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            "for argv in sys.argv[1:]:\n"
            "    dryrun.main(argv.split() + ['--out', sys.argv[0]])\n")
    argv = [" ".join(["--reduced", "--arch", a, "--shape", s, "--mesh", m, *extra])
            for a, s, m, extra in CELLS]
    r = subprocess.run([sys.executable, "-c", code.replace("sys.argv[0]", repr(str(out))),
                        *argv], capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin:/usr/local/bin",
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-4000:]
    return out


def _bytes(tree, shard, mesh) -> int:
    total = 0
    for leaf, ns in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shard, is_leaf=lambda x: isinstance(x, NamedSharding))):
        total += math.prod(ns.shard_shape(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return total


def jax_argument_bytes(arch, shape_name, mesh_name, quant, group) -> dict:
    """JAX's per-rank bytes of the decode step's arguments: params (bf16, or
    packed), tokens, cache and positions, as its dry run lays them out."""
    cfg, model = j_get_model(arch, reduced=True)
    shape = SHAPES[shape_name]
    B, S = min(shape.global_batch, 8), min(shape.seq_len, 64)
    mesh = AbstractMesh(*MESHES[mesh_name])
    plan = JPlan(mesh=mesh, strategy=j_pick_strategy(cfg, "decode"), cfg=cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    if quant is None:
        params = jax.eval_shape(lambda p: jax.tree.map(
            lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating)
            else x, p), params)
    else:
        params = jax.eval_shape(lambda p: jdeploy.quantize_tree(p, quant, group), params)
    cache = jax.eval_shape(lambda: model.init_cache(B, S, jnp.bfloat16))
    bspec = plan.batch_spec(B, 2)
    tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    pos = jax.ShapeDtypeStruct((B,), jnp.int32)
    return {"params": _bytes(params, plan.params_sharding(params), mesh),
            "tokens": _bytes(tok, NamedSharding(mesh, bspec), mesh),
            "cache": _bytes(cache, plan.cache_sharding(cache, B), mesh),
            "pos": _bytes(pos, NamedSharding(mesh, JP(bspec[0])), mesh)}


@pytest.mark.parametrize("arch,shape,mesh,extra", CELLS, ids=["tinyllama_w4", "deepseek_multi"])
def test_dryrun_cell_matches_jax_layout(artifacts, arch, shape, mesh, extra):
    quant = int(extra[1]) if extra else None
    group = int(extra[3]) if extra else None
    tag = f"_{extra[-1]}" if extra else ""
    d = json.loads((artifacts / f"{arch}_{shape}_{mesh}{tag}.json").read_text())
    assert d["reduced"] and d["n_chips"] == 8 and d["quant"] == quant
    assert d["argument_bytes"] == jax_argument_bytes(arch, shape, mesh, quant, group)
    assert d["flops_per_rank"] > 0 and d["bytes_per_rank"] > 0
    assert d["collective_counts"] and d["collective_bytes_total"] > 0
    assert d["fits_80gb"] is True and d["peak_bytes"] >= d["argument_bytes_total"]
    assert set(d["roofline"]) >= {"compute_s", "memory_s", "collective_s", "bottleneck"}


def test_roofline_table_reads_the_artifacts(artifacts, capsys):
    from benchmarks_torch import roofline_table

    rows = roofline_table.main(artifacts)
    out = capsys.readouterr().out
    assert [r["arch"] for r in rows] == ["deepseek_moe_16b"]  # tagged variants aside
    assert "roofline/deepseek_moe_16b_decode_32k_multi," in out
    assert rows[0]["fix"] == roofline_table.FIX_HINTS[rows[0]["bottleneck"]]
