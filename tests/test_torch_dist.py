"""The port's distribution plane against the JAX package's, in this process.

* ``dist/sharding.py``'s Plan against ``repro.dist.sharding.Plan`` on
  ``jax.sharding.AbstractMesh`` (no devices): every spec of every fp tree
  of the 11 configs at full width and of the packed W2 / W4 g64 / W3 trees
  of reduced tinyllama and qwen3-moe, under dp, tp, fsdp (over data and
  over model), zero3 and tp/fsdp with experts unsharded, on the (4, 2)
  data x model, (2, 2, 2) pod x data x model and (8,) data meshes, entry for
  entry; the local shape of each spec, and of the DTensor placements it
  turns into, against ``NamedSharding(...).shard_shape``; ``batch_spec``
  and ``cache_spec``; ``pick_strategy``; the JAX package's own rule tests
  (``test_param_specs_unit``, ``test_packed_param_rules_unit``) on the port.
* ``make_dp_train_step`` at world 1 (no process group) against JAX's
  ``shard_map`` step on a one-device mesh, 4 steps of reduced brecq, each
  from JAX's state: the loss within 1e-5 relative; the error buffer within
  the gradients' tolerance of ``test_torch_train.py`` (1e-4 * max|leaf| +
  1e-7) except at codes that round the other way on a tie (at most
  ``TIE_MAX`` elements, each off by at most one scale); the params within
  1e-6 except at those elements (within 2 * lr).
* ``make_train_step`` at world 1 against JAX's, jitted on a (1, 1) mesh of
  Auto axes, one step: bf16 compute, so the loss within 1e-3 relative and
  the gradient norm within 3e-3; Adam's first step is lr * sign(g), so a
  gradient element that rounds to the other sign moves its weight by
  2 * lr: every param within 2 * lr, and all but 1% within 1e-6.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as JP
from jax._src.named_sharding import DuplicateSpecError

from repro import deploy as jdeploy
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.dist.sharding import Plan as JPlan
from repro.dist.sharding import pick_strategy as j_pick_strategy
from repro.launch import steps as jsteps
from repro.models import ARCH_IDS
from repro.models import get_model as j_get_model
from repro.optim import adam as jadam
from repro.optim.grad_compress import init_error as j_init_error
from repro.optim.grad_compress import make_dp_train_step as j_make_dp_train_step
from repro_torch.configs.base import ShapeSpec
from repro_torch.deploy.pack import quantize_tree
from repro_torch.dist.sharding import Plan, local_shape, pick_strategy, placements
from repro_torch.interop import flatten_paths, params_from_numpy, params_to_numpy
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import MeshSpec, make_host_mesh, make_production_mesh
from repro_torch.models import get_model
from repro_torch.optim import adam
from repro_torch.optim.grad_compress import init_error, make_dp_train_step
from test_torch_models import np_params
from torch_threads import one_torch_thread  # noqa: F401


MESHES = [((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((8,), ("data",))]
TIE_MAX = 16


def plans(jcfg, cfg, sizes, names):
    """(JAX plan, port plan) pairs: every strategy, fsdp over each axis,
    and tp/fsdp with the expert stacks unsharded."""
    am, ms = AbstractMesh(sizes, names), MeshSpec(sizes, names)
    out = []
    for strategy in ("dp", "tp", "fsdp", "zero3"):
        axes = [a for a in ("data", "model") if a in names] if strategy == "fsdp" else ["data"]
        for fa in axes:
            for se in ((True, False) if strategy in ("tp", "fsdp") else (True,)):
                kw = dict(strategy=strategy, fsdp_axis=fa, shard_experts=se)
                out.append((JPlan(mesh=am, cfg=jcfg, **kw), Plan(mesh=ms, cfg=cfg, **kw)))
    return out


def placement_shape(shape, pl, mesh: MeshSpec) -> tuple:
    """The local shape DTensor gives ``placements`` on a mesh of these sizes
    (a dim split over several mesh dims, in mesh order)."""
    out = list(shape)
    for size, p in zip(mesh.axis_sizes, pl):
        if p.is_shard():
            assert out[p.dim] % size == 0
            out[p.dim] //= size
    return tuple(out)


def jax_specs(jplan, tree) -> dict:
    """JAX's spec of every leaf, by the walk of ``Plan.params_sharding``
    without building the ``NamedSharding`` (which rejects a spec naming an
    axis twice: the packed expert rule under fsdp over ``model``)."""
    def walk(node, keys):
        if not isinstance(node, dict):
            return jplan._param_spec(keys, tuple(node.shape))
        if "qscale" in node or "table_qscale" in node:
            return {k: (jplan._packed_spec(keys + (k,), tuple(v.shape)) if k == "w" else
                        jplan._param_spec(keys + (k,), tuple(v.shape)) if k == "table" else
                        JP(*([None] * len(v.shape)))) for k, v in node.items()}
        return {k: walk(v, keys + (k,)) for k, v in node.items()}

    return flatten_paths(walk(tree, ()))


def assert_same_specs(jplan, plan, jtree, ttree):
    js = jax_specs(jplan, jtree)
    ts = flatten_paths(plan.params_spec(ttree))
    shapes = flatten_paths(ttree)
    assert js.keys() == ts.keys()
    for k, spec in js.items():
        want = tuple(spec) + (None,) * (len(ts[k]) - len(spec))
        assert ts[k] == want, (plan.strategy, plan.mesh.shape, k, ts[k], want)
        shape = tuple(shapes[k].shape)
        try:
            local = NamedSharding(jplan.mesh, spec).shard_shape(shape)
        except (ValueError, DuplicateSpecError):  # JAX rejects it; so must the port
            with pytest.raises(ValueError):
                plan.placements(ts[k])
            continue
        assert local_shape(shape, ts[k], plan.mesh) == local, k
        assert placement_shape(shape, plan.placements(ts[k]), plan.mesh) == local, k
    return len(js)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fp_param_specs_match_jax(arch):
    jcfg, jmodel = j_get_model(arch)
    cfg, model = get_model(arch)
    jtree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    ttree = specs.params_specs(model)
    n = sum(assert_same_specs(jp, tp, jtree, ttree)
            for sizes, names in MESHES for jp, tp in plans(jcfg, cfg, sizes, names))
    assert n > 0


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen3_moe_235b_a22b"])
@pytest.mark.parametrize("bits,group", [(2, None), (4, 64), (3, None)])
def test_packed_param_specs_match_jax(arch, bits, group):
    jcfg, jmodel = j_get_model(arch, reduced=True)
    cfg, model = get_model(arch, reduced=True)
    jtree = jax.eval_shape(lambda p: jdeploy.quantize_tree(p, bits, group),
                           jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0))))
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    fp = specs.params_specs(model, mode)
    with mode:
        ttree = quantize_tree(fp, bits, group)
    assert flatten_paths(ttree).keys() == flatten_paths(jtree).keys()
    for sizes, names in MESHES:
        for jp, tp in plans(jcfg, cfg, sizes, names):
            assert_same_specs(jp, tp, jtree, ttree)


def test_batch_and_cache_specs_match_jax():
    jcfg, jmodel = j_get_model("hymba_1_5b", reduced=True)
    cfg, model = get_model("hymba_1_5b", reduced=True)
    for sizes, names in MESHES:
        for jp, tp in plans(jcfg, cfg, sizes, names):
            for seq_parallel in (True, False):
                jp = dataclasses.replace(jp, seq_parallel=seq_parallel)
                tp = dataclasses.replace(tp, seq_parallel=seq_parallel)
                for gb in (1, 3, 4, 8, 16):
                    assert tp.batch_axes(gb) == jp.batch_axes(gb)
                    for ndim, seq in ((2, 0), (2, 256), (3, 512), (3, 64)):
                        want = tuple(jp.batch_spec(gb, ndim, 1, seq))
                        want += (None,) * (ndim - len(want))
                        assert tp.batch_spec(gb, ndim, 1, seq) == want
    am, ms = AbstractMesh((4, 2), ("data", "model")), MeshSpec((4, 2), ("data", "model"))
    for arch in ("tinyllama_1_1b", "hymba_1_5b", "xlstm_350m", "deepseek_moe_16b"):
        jcfg, jmodel = j_get_model(arch, reduced=True)
        cfg, model = get_model(arch, reduced=True)
        for gb, S in ((8, 64), (3, 128), (1, 32)):
            jc = jax.eval_shape(lambda: jmodel.init_cache(gb, S, jnp.bfloat16))
            from torch._subclasses.fake_tensor import FakeTensorMode

            with FakeTensorMode():
                tc = model.init_cache(gb, S, torch.bfloat16)
            jleaves, tleaves = flatten_paths(jc), flatten_paths(tc)
            assert jleaves.keys() == tleaves.keys()
            for strategy in ("dp", "tp", "fsdp"):
                jp = JPlan(mesh=am, strategy=strategy, cfg=jcfg)
                tp = Plan(mesh=ms, strategy=strategy, cfg=cfg)
                jspecs = flatten_paths(jp.cache_sharding(jc, gb))
                tspecs = flatten_paths(tp.cache_specs(tc, gb))
                for k, ns in jspecs.items():
                    shape = tuple(tleaves[k].shape)
                    want = tuple(ns.spec) + (None,) * (len(shape) - len(ns.spec))
                    assert tspecs[k] == want, (arch, strategy, k)
                    assert local_shape(shape, tspecs[k], ms) == ns.shard_shape(shape)


def test_pick_strategy_matches_jax():
    for arch in ARCH_IDS:
        jcfg, cfg = j_get_model(arch)[0], get_model(arch)[0]
        for kind in ("train", "prefill", "decode"):
            assert pick_strategy(cfg, kind) == j_pick_strategy(jcfg, kind), (arch, kind)


def test_param_specs_unit():
    """The JAX package's ``test_param_specs_unit``, on the port's Plan."""
    mesh = MeshSpec((4, 2), ("data", "model"))
    cfg = get_model("tinyllama_1_1b")[0]
    plan = Plan(mesh=mesh, strategy="tp", cfg=cfg)
    s = plan.param_spec(("body", "sub0", "attn", "wq", "w"), (22, 2048, 2048))
    assert s[-1] == "model" and s[-2] is None, s
    s = plan.param_spec(("body", "sub0", "attn", "wo", "w"), (22, 2048, 2048))
    assert s[-2] == "model" and s[-1] is None, s
    s = plan.param_spec(("body", "sub0", "norm1", "g"), (22, 2048))
    assert all(x is None for x in s)
    plan_moe = Plan(mesh=mesh, strategy="fsdp", cfg=get_model("qwen3_moe_235b_a22b")[0])
    s = plan_moe.param_spec(("moe", "sub0", "moe", "w_gate", "w"), (94, 128, 4096, 1536))
    assert s[1] == "model" and s[-1] == "data", s
    plan_z = Plan(mesh=mesh, strategy="zero3", cfg=cfg)
    s = plan_z.param_spec(("body", "sub0", "mlp", "w_up", "w"), (22, 2048, 5632))
    assert s[-1] == ("data", "model"), s


def test_packed_param_rules_unit():
    """The JAX package's ``test_packed_param_rules_unit``, on the port's
    Plan: codes along N only, qscale replicated, the int8 table
    vocab-parallel, W3 in an int8 container, packed experts E over model
    and N over the fsdp axis."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = MeshSpec((4, 2), ("data", "model"))
    cfg, model = get_model("tinyllama_1_1b", reduced=True)
    plan = Plan(mesh=mesh, strategy="tp", cfg=cfg)
    mode = FakeTensorMode()
    params = specs.params_specs(model, mode)
    with mode:
        packed = quantize_tree(params, 4, 64)
        packed3 = quantize_tree(params, 3, None)
    sh = plan.params_spec(packed)
    assert packed["body"]["sub0"]["attn"]["wq"]["w"].dtype == torch.int8
    a = sh["body"]["sub0"]["attn"]
    assert a["wq"]["w"][-1] == "model"
    assert a["wo"]["w"][-1] == "model" and a["wo"]["w"][-2] is None
    assert all(s is None for s in a["wq"]["qscale"])
    assert sh["embed"]["table"][0] == "model"
    assert all(s is None for s in sh["embed"]["table_qscale"])
    w3 = packed3["body"]["sub0"]["attn"]["wq"]["w"]
    assert w3.shape[-2] == params["body"]["sub0"]["attn"]["wq"]["w"].shape[-2]
    assert plan.params_spec(packed3)["body"]["sub0"]["attn"]["wq"]["w"][-1] == "model"
    cfg2, model2 = get_model("qwen3_moe_235b_a22b", reduced=True)
    plan2 = Plan(mesh=mesh, strategy="fsdp", cfg=cfg2)
    with mode:
        pk2 = quantize_tree(specs.params_specs(model2, mode), 4, None)
    moe = pk2["moe"]["sub0"]["moe"]
    assert "qscale" not in moe["router"] and "qscale" in moe["w_gate"]
    msh = plan2.params_spec(pk2)["moe"]["sub0"]["moe"]
    assert msh["w_gate"]["w"][1] == "model" and msh["w_gate"]["w"][-1] == "data"
    assert all(s is None for s in msh["w_gate"]["qscale"])


def test_placements_keep_the_mesh_order_or_raise():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshSpec((2, 2, 2), ("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements((None,), mesh) == [Replicate()] * 3
    for bad in ((("data", "pod"),), ("model", "model"), ("expert",)):
        with pytest.raises(ValueError):
            placements(bad, mesh)


def test_meshes():
    assert make_production_mesh().shape == {"data": 32, "model": 8}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 32, "model": 8}
    assert make_host_mesh(1).shape == {"data": 1, "model": 1}  # world 1, no group
    with pytest.raises(ValueError, match="model axis of 2 does not divide the 1 ranks"):
        make_host_mesh(2)


def _from_jax(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def test_int8_dp_step_at_world_one_matches_jax():
    jcfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    cfg, model = get_model("brecq_lm_100m", reduced=True)
    jmesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    jstep = j_make_dp_train_step(jmodel, jmesh, jadam.AdamConfig(lr=1e-3, grad_clip=1.0),
                                 remat="none")
    step = make_dp_train_step(model, MeshSpec((1,), ("data",)),
                              adam.AdamConfig(lr=1e-3, grad_clip=1.0), remat="none")
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, np_params(jmodel))
    jo, je = jadam.init(jp), j_init_error(jp)
    for _ in range(4):
        toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        tp, to, te = _from_jax(jp), _from_jax(jo), _from_jax(je)
        tp2, _, te2, loss = step(tp, to, te, {"tokens": torch.from_numpy(toks)})
        jp, jo, je, jloss = jstep(jp, jo, je, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        got_p, want_p = flatten_paths(params_to_numpy(tp2)), flatten_paths(_np(jp))
        got_e, want_e = flatten_paths(params_to_numpy(te2)), flatten_paths(_np(je))
        ties = 0
        for k, w in want_e.items():
            off = np.abs(got_e[k] - w) > 1e-4 * np.abs(w).max() + 1e-7
            ties += int(off.sum())
            # one code the other way moves the residual by one scale
            scale = max(np.abs(w).max() * 2, 1e-12)
            assert np.all(np.abs(got_e[k] - w) <= scale * 1.01), k
            dp = np.abs(got_p[k] - want_p[k])
            assert np.all(dp[~off] <= 1e-6) and np.all(dp <= 2e-3), k
        assert ties <= TIE_MAX, ties


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_train_step_at_world_one_matches_jax():
    jcfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    cfg, model = get_model("brecq_lm_100m", reduced=True)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jlow = jsteps.make_train_step(jmodel, JPlan(mesh=jmesh, strategy="tp", cfg=jcfg),
                                  JShapeSpec("t", seq_len=32, global_batch=4, kind="train"),
                                  remat="none")
    st = steps.make_train_step(model, Plan(mesh=MeshSpec((1, 1), ("data", "model")),
                                           strategy="tp", cfg=cfg),
                               ShapeSpec("t", seq_len=32, global_batch=4, kind="train"))
    p = np_params(jmodel)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    jp2, _, jm = jlow.jit()(jp, jadam.init(jp), {"tokens": jnp.asarray(toks)})
    tp = params_from_numpy(p, device="cpu")
    tp2, _, m = st.fn(tp, adam.init(tp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]), rtol=3e-3)
    lr = 3e-4  # the step's default AdamConfig, as JAX's
    got, want = flatten_paths(params_to_numpy(tp2)), flatten_paths(_np(jp2))
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * lr * (1 + 1e-3) + 1e-7, d.max()
    assert (d > 1e-6).mean() < 0.01, (d > 1e-6).mean()
    assert math.isfinite(float(m["loss"]))
