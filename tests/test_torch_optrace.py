"""One eager step's summary (``repro_torch.analysis.optrace``) on the CPU.

``analyze_step`` is the port's counterpart of the JAX package's
``analysis/hlo.py``: on the forward of the reduced brecq-lm-100m (2 x 32
tokens) it gives the dot FLOPs that JAX's ``analyze_module`` reads off the
compiled forward (the layer scan times its trip count), within 1e-6
relative. The kernel wrappers report each call to the recorder
(``kernels/record.py``): a packed W4 decode on the plain path reads exactly
the packed leaves' bytes, and the plain version's own ops are not counted
twice. Collective bytes are each collective's local operand bytes, held in
closed form on a small DTensor program over a fake 8-rank group, and equal
the dry run's on its fake-group tinyllama W4 decode cell
(``tests/test_torch_dist_dryrun.py``); both in a subprocess, as the dry-run
test runs it. ``roofline.from_step`` is ``from_trace`` over the
summary; ``from_hlo`` names both.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo import analyze_module
from repro.models import get_model as j_get_model
from repro_torch.analysis import roofline
from repro_torch.analysis.optrace import StepSummary, analyze_step, op_bytes
from repro_torch.configs.base import SHAPES
from repro_torch.deploy import rtn_artifact
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import record
from repro_torch.kernels.kvattn.ops import attend_int8, quantize_kv
from repro_torch.models import get_model
from torch_threads import one_torch_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parents[1] / "src")


def test_forward_flops_match_jax():
    cfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    fwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0])
    want = analyze_module(fwd.lower(jparams, jnp.asarray(toks)).compile().as_text())
    _, model = get_model("brecq_lm_100m", reduced=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    with torch.inference_mode():
        got = analyze_step(model.forward, (params, {"tokens": torch.from_numpy(toks)}))
    assert want.flops > 0
    assert got.flops == pytest.approx(want.flops, rel=1e-6, abs=0)
    # Bytes: XLA:CPU leaves only the dots at the top level of the compiled
    # module, and ``analyze_module`` counts a fusion op's bytes as none; the
    # reductions (RMS norms, softmax) and the embedding gather sit inside
    # fusions there. So the dots' bytes agree exactly, and the rest of
    # optrace's bytes are what the reference puts inside fusions.
    dot_bytes = sum(r["bytes"] for k, r in got.by_op.items() if k in ("aten.mm", "aten.bmm"))
    assert dot_bytes == pytest.approx(want.bytes, rel=1e-6, abs=0)
    rest = {k: r["bytes"] for k, r in got.by_op.items() if k not in ("aten.mm", "aten.bmm")}
    assert got.bytes - dot_bytes == pytest.approx(sum(rest.values()))
    assert 0 < sum(rest.values()) < 0.2 * want.bytes
    assert got.collective_bytes == want.collective_bytes == 0.0
    assert got.fusion_dot_flops == 0.0 and got.launches == {}
    # dots, reductions and the embedding gather move bytes; element-wise work none
    assert {k.split(".")[1] for k in got.by_op} <= {"mm", "bmm", "mean", "amax", "sum",
                                                    "index", "_softmax", "addmm"}
    assert got.bytes == pytest.approx(sum(r["bytes"] for r in got.by_op.values()))


def test_recorder_reads_the_packed_leaves():
    """A packed W4 decode step on the plain path: the recorded weight bytes
    are the summed nbytes of every packed leaf (``w`` and ``qscale``), one
    ``qgemv`` call for each packed matmul of each layer, and the plain
    version's ops inside those calls are not counted again."""
    cfg, model = get_model("brecq_lm_100m", reduced=True)
    params = model.init(torch.Generator().manual_seed(0))
    art = rtn_artifact(params, 4, cfg=cfg)
    packed, n_calls = 0, 0

    def walk(node):
        nonlocal packed, n_calls
        if isinstance(node, dict):
            if "qscale" in node:
                packed += node["w"].nbytes + node["qscale"].nbytes
                n_calls += node["w"].shape[0] if node["w"].ndim == 3 else 1
            for v in node.values():
                walk(v)

    walk(art.params)
    cache = model.init_cache(2, 16, torch.float32, "cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.full((2,), 4, dtype=torch.int32)
    with torch.inference_mode():
        s = analyze_step(model.decode_step, (art.params, tok, cache, pos, art.hook()))
    assert isinstance(s, StepSummary)
    assert s.weight_bytes == packed and s.launches == {"qgemv": n_calls}
    assert s.by_op["kernel.qgemv"]["calls"] == n_calls
    assert s.fusion_dot_flops == s.by_op["kernel.qgemv"]["flops"] > 0
    # outside the kernels: attention's dots on the cache, the head's matmul
    # on the tied table, and no unpacking of the codes (qgemv_ref's own ops)
    dots = sum(r["flops"] for k, r in s.by_op.items() if k.startswith("aten."))
    assert s.flops == pytest.approx(s.fusion_dot_flops + dots)
    assert record._RECORDER is None


def test_kernel_work_formulas():
    """Each input read once, the output written once (chip_smoke.py's bounds)."""
    m, k, n, bits, g = 8, 768, 3072, 4, 6
    w = record.qmm_work("qgemv", 1, m, k, n, bits, g)
    assert w.bytes == m * k * 4 + k * n * bits // 8 + g * n * 4 + m * n * 4
    assert w.flops == 2 * m * k * n and w.weight_bytes == k * n // 2 + g * n * 4
    assert record.fq_work(k, n, 1) == record.Work("fakequant", 0.0, 4.0 * (3 * k * n + n))
    B, H, K, hd, S = 2, 8, 2, 64, 32
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(B, H, hd, generator=gen)
    k8, v8, ks, vs = quantize_kv(torch.randn(B, S, K, hd, generator=gen),
                                 torch.randn(B, S, K, hd, generator=gen))
    kpos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    cur = torch.full((B,), S - 1, dtype=torch.int32)
    s = analyze_step(attend_int8, (q, k8, v8, ks, vs, kpos, cur))
    assert s.launches == {"kv_decode": 1}
    want = 2 * B * H * hd * 4 + B * 4 + B * S * 4 + 2 * (k8.nbytes + ks.nbytes)
    assert s.bytes == want and s.flops == 4 * B * H * S * hd
    assert list(s.by_op) == ["kernel.kv_decode"]  # the plain version's ops left out


def test_op_bytes_perfect_fusion():
    x, w = torch.ones(4, 8), torch.ones(8, 16)
    out = x @ w
    assert op_bytes("mm", (x, w), {}, out) == (32 + 128 + 64) * 4
    assert op_bytes("add", (x, x), {}, x + x) == 0  # fused
    idx = torch.tensor([0, 2])
    assert op_bytes("index", (w, [idx]), {}, w[idx]) == 2 * 2 * 16 * 4
    vals = torch.ones(2, 16)
    assert op_bytes("index_put_", (w, [idx], vals), {}, w) == 2 * vals.nbytes
    assert op_bytes("scatter_add", (w, 0, idx[:, None].expand(2, 16), vals), {}, w) \
        == 3 * vals.nbytes
    assert op_bytes("sum", (x,), {}, x.sum()) == x.nbytes + 4


def test_from_step_is_from_trace_and_from_hlo_names_it():
    from repro_torch.models import get_config

    cfg, shape = get_config("brecq_lm_100m"), SHAPES["decode_32k"]
    s = StepSummary(flops=3e9, bytes=5e7, collective_bytes=1e6,
                    collective_counts={"all_reduce": 2}, fusion_dot_flops=1e9)
    got = roofline.from_step(s, cfg, shape, 1, w_bits=4)
    assert got == roofline.from_trace(3e9, 5e7, 1e6, cfg, shape, 1, w_bits=4)
    assert got.bottleneck == "memory" and got.mem_frac > 0
    with pytest.raises(NotImplementedError, match="analyze_step") as e:
        roofline.from_hlo("", cfg, shape, 1)
    assert "from_step" in str(e.value) and "15c/15d" in str(e.value)


B, K, N, R, C = 8, 64, 48, 32, 16  # the closed-form program's shapes


@pytest.fixture(scope="module")
def fake_group():
    """One process on a fake 8-rank group: the dry run's tinyllama W4 decode
    cell with ``analyze_step`` over the same step, and ``analyze_step`` over
    a small DTensor program on a (4, 2) mesh whose collectives are known in
    closed form (``test_collective_bytes_closed_form``)."""
    code = (
        "import json, torch, torch.distributed as dist\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "from torch.distributed.tensor import distribute_tensor, Replicate, Shard\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.analysis.optrace import analyze_step\n"
        "args = dryrun.parse_args('--reduced --arch tinyllama_1_1b --shape decode_32k "
        "--quant 4 --group 64'.split())\n"
        "cell = dryrun.run_cell(args)\n"
        "step, fake = dryrun.cell_step(args)[4:6]\n"
        "s = analyze_step(step.trace, (fake,))\n"
        "out = {'dry': [cell['collective_bytes_total'], cell['collective_counts'],"
        " s.collective_bytes, s.collective_counts]}\n"
        "dm = init_device_mesh('cpu', (4, 2), mesh_dim_names=('data', 'model'))\n"
        f"B, K, N, R, C = {B}, {K}, {N}, {R}, {C}\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = distribute_tensor(torch.randn(B, K, generator=g), dm, [Replicate(), Replicate()])\n"
        "w = distribute_tensor(torch.randn(K, N, generator=g), dm, [Replicate(), Shard(0)])\n"
        "y = distribute_tensor(torch.randn(R, C, generator=g).bfloat16(), dm,"
        " [Shard(0), Replicate()])\n"
        "def explicit(x, w, y):\n"
        "    (x @ w).redistribute(dm, [Replicate(), Replicate()])\n"
        "    (x @ w).redistribute(dm, [Replicate(), Shard(0)])\n"
        "    return y.full_tensor()\n"
        "def native(h):\n"
        "    dist.all_reduce(h)\n"
        "    dist.all_gather_into_tensor(torch.empty(8 * 5, 7, dtype=torch.int8), h)\n"
        "out['closed'] = []\n"
        "for fn, a in ((explicit, (x, w, y)), (lambda x, w: torch.relu(x @ w), (x, w)),\n"
        "              (native, (torch.ones(5, 7, dtype=torch.int8),))):\n"
        "    s = analyze_step(fn, a)\n"
        "    out['closed'].append([s.collective_bytes, s.collective_counts])\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.splitlines()[-1])


def test_collective_bytes_match_dry_run(fake_group):
    """The dry run's tinyllama W4 decode cell on 8 fake ranks: ``analyze_step``
    over the same step counts the collective bytes and counts the dry run
    reports (both through ``optrace.comm_mode``; its bytes are held in
    closed form below)."""
    dry_bytes, dry_counts, got_bytes, got_counts = fake_group["dry"]
    assert dry_bytes > 0 and dry_counts
    assert got_bytes == dry_bytes and got_counts == dry_counts


def test_collective_bytes_closed_form(fake_group):
    """Each collective's local operand bytes, on a fake 8-rank (4, 2) mesh:
    a row-parallel matmul's Partial output all-reduced (B x N f32) and
    reduce-scattered (B x N f32 in), a bf16 tensor sharded over ``data``
    gathered (R/4 x C bf16 in), an implicit all-reduce from an element-wise
    op on a Partial, which autograd wraps (B x N f32, counted once), and the
    native ``dist.all_reduce`` (in place) and ``all_gather_into_tensor`` (its
    input only) on int8."""
    explicit, implicit, native = fake_group["closed"]
    assert explicit == [B * N * 4 + B * N * 4 + R // 4 * C * 2,
                        {"all_reduce": 1, "reduce_scatter_tensor": 1,
                         "all_gather_into_tensor": 1}]
    assert implicit == [B * N * 4, {"all_reduce": 1}]
    assert native == [5 * 7 + 5 * 7, {"allreduce_": 1, "_allgather_base_": 1}]
