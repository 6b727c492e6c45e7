"""Port parity: the MoE family (repro_torch.models.moe and the MoE stacks
of repro_torch.models.transformer) vs the JAX package.

The same numpy-made params go through both packages. ``moe.apply`` (dense
and capacity routing, with and without dropped picks) and ``aux_loss``
agree to 1e-5; reduced deepseek-moe-16b (a dense0 layer, shared experts)
and reduced qwen3-moe-235b-a22b (no shared experts, GQA, qk-norm) agree
to 1e-4 in FP forward, prefill and decode, and packed W4/W2 through the
grouped ``qmm`` tier, for both ``moe_impl``s, with identical greedy
tokens (f32 sums in another order). RTN MoE artifacts load verified in
both directions with identical digests, and MoE decode never routes an
expert node through ``dequant_leaf`` or the (E, K, N) dense reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.models.common import Ctx as JCtx
from repro_torch.deploy import QuantizedArtifact, pack, rtn_artifact
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.qmatmul import ops
from repro_torch.models import build_model, get_config, get_model
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Ctx
from test_torch_models import both, np_params, tokens

TOL = 1e-4
MOE_TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the MoE layer: MoESpec(32, 64, 4, 2, n_shared=1), the JAX smoke test's case
# ---------------------------------------------------------------------------


def layer_params(seed=0):
    spec = jmoe.MoESpec(32, 64, 4, 2, n_shared=1)
    shapes = jax.eval_shape(lambda k: jmoe.init(k, spec), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.uniform(-1, 1, s.shape) / np.sqrt(s.shape[-2])).astype(np.float32),
        shapes)


def layer_both(impl, cf, seed=0):
    p = layer_params(seed)
    x = np.random.default_rng(seed + 1).standard_normal((2, 16, 32)).astype(np.float32)
    kw = dict(n_shared=1, impl=impl, capacity_factor=cf)
    jspec, tspec = jmoe.MoESpec(32, 64, 4, 2, **kw), tmoe.MoESpec(32, 64, 4, 2, **kw)
    jctx = JCtx(cfg=None, positions=jnp.zeros((2, 16), jnp.int32))
    tctx = Ctx(cfg=None, positions=torch.zeros((2, 16), dtype=torch.int32))
    return ((jctx, jax.tree.map(jnp.asarray, p), jspec, jnp.asarray(x)),
            (tctx, params_from_numpy(p, device="cpu"), tspec, torch.from_numpy(x)))


# cf 4.0: capacity holds every pick; 1.0: cap 8 of 16 tokens, picks dropped
@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("capacity", 4.0),
                                     ("capacity", 1.0)])
def test_moe_apply_and_aux_loss_match_jax(impl, cf):
    (jargs, targs) = layer_both(impl, cf)
    close(tmoe.apply(*targs), jmoe.apply(*jargs), MOE_TOL)
    close(float(tmoe.aux_loss(*targs)), float(jmoe.aux_loss(*jargs)), MOE_TOL)
    if impl == "capacity":
        dropped, picks = tmoe.dropped_picks(*targs)
        assert picks == 2 * 16 * 2 and (dropped == 0) == (cf == 4.0)


def test_moe_dense_and_capacity_agree():
    """With room for every pick, capacity routing is exact token choice."""
    _, (ctx, p, spec, x) = layer_both("capacity", 4.0)
    dense = tmoe.MoESpec(32, 64, 4, 2, n_shared=1, impl="dense")
    np.testing.assert_allclose(tmoe.apply(ctx, p, dense, x).numpy(),
                               tmoe.apply(ctx, p, spec, x).numpy(), atol=2e-5)


def test_topk_and_capacity_follow_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, 9)).astype(np.float32)
    tv, ti = tmoe._topk(torch.from_numpy(x), 3)
    jv, ji = jmoe._topk(jnp.asarray(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    spec = tmoe.MoESpec(2048, 1408, 64, 6)
    # round(7.5) = 8 and round(3.75) = 4: Python's half-to-even round
    assert (tmoe.capacity(spec, 64), tmoe.capacity(spec, 32), tmoe.capacity(spec, 1)) == (8, 4, 1)


# ---------------------------------------------------------------------------
# reduced MoE models through both packages
# ---------------------------------------------------------------------------


def models(arch, impl):
    _, jmodel = j_get_model(arch, reduced=True, moe_impl=impl)
    cfg, model = get_model(arch, reduced=True, moe_impl=impl)
    assert model.moe_impl == jmodel.moe_impl == impl
    return cfg, jmodel, model


def serve_both(cfg, jmodel, model, jp, tp, b=2, s=12, steps=3):
    """Prefill + greedy decode in both packages: logits within 1e-4 and the
    same greedy token at every step."""
    toks = tokens(cfg.vocab, b, s)
    jc = jmodel.init_cache(b, s + steps, jnp.float32)
    tc = model.init_cache(b, s + steps, torch.float32)
    jl, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, {"tokens": t}, c, remat="none"))(
        jp, jnp.asarray(toks), jc)
    jstep = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    with torch.inference_mode():
        tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
        for i in range(steps + 1):
            close(tl, jl)
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
            np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok[:, 0])
            if i == steps:
                break
            pos = np.full((b,), s + i, np.int32)
            jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
            tl, tc = model.decode_step(tp, torch.from_numpy(tok), tc,
                                       torch.from_numpy(pos))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "qwen3_moe_235b_a22b"])
@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_fp_forward_and_serve_match_jax(arch, impl):
    cfg, jmodel, model = models(arch, impl)
    jp, tp = both(np_params(jmodel, seed=4))
    toks = tokens(cfg.vocab, 2, 16)
    jl, jaux = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, remat="none")
    tl, taux = model.forward(tp, {"tokens": torch.from_numpy(toks)})
    close(tl, jl)
    close(float(taux), float(jaux), MOE_TOL)
    assert float(taux) > 0
    serve_both(cfg, jmodel, model, jp, tp)


@pytest.mark.parametrize("arch,impl,bits", [
    ("deepseek_moe_16b", "dense", 4), ("deepseek_moe_16b", "capacity", 4),
    ("deepseek_moe_16b", "capacity", 2), ("qwen3_moe_235b_a22b", "capacity", 4),
    ("qwen3_moe_235b_a22b", "dense", 2)])
def test_packed_serve_matches_jax(arch, impl, bits):
    """Packed params: every expert matmul runs the grouped qmm tier."""
    cfg, jmodel, model = models(arch, impl)
    jp, tp = both(np_params(jmodel, seed=5), bits)
    w = tp["moe"]["sub0"]["moe"]["w_gate"]
    E, K, N = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert w["w"].shape == (cfg.n_layers - cfg.moe.first_k_dense, E, K * bits // 8, N)
    assert w["qscale"].shape[-3:] == (E, 1, N)
    assert tp["moe"]["sub0"]["moe"]["router"]["w"].dtype == torch.float32
    ops.reset_tier_counts()
    serve_both(cfg, jmodel, model, jp, tp)
    assert ops.TIER_COUNTS["grouped"] > 0
    ops.reset_tier_counts()


def test_moe_impl_default_rule_and_stacks():
    """capacity when n_experts >= 16, else dense (the JAX rule); the
    deepseek stacks are one dense0 layer then the MoE layers."""
    for arch, reduced, impl in (("deepseek_moe_16b", False, "capacity"),
                                ("deepseek_moe_16b", True, "dense"),
                                ("qwen3-moe-235b-a22b", False, "capacity")):
        assert build_model(get_config(arch, reduced=reduced)).moe_impl == impl
    model = build_model(get_config("deepseek-moe-16b"))
    assert [(s.name, s.n, s.subs[0].ffn, s.subs[0].d_ff) for s in model.stacks] == [
        ("dense0", 1, "mlp", 10944), ("moe", 27, "moe", 0)]
    assert [s.name for s in get_model("qwen3_moe_235b_a22b", reduced=True)[1].stacks] == ["moe"]


# ---------------------------------------------------------------------------
# artifacts and decode residency on reduced deepseek-moe-16b
# ---------------------------------------------------------------------------


def prefill_logits(model, params, toks, pkg):
    b, s = toks.shape
    if pkg == "jax":
        cache = model.init_cache(b, s, jnp.float32)
        return np.asarray(model.prefill(params, {"tokens": jnp.asarray(toks)}, cache,
                                        remat="none")[0])
    with torch.inference_mode():
        cache = model.init_cache(b, s, torch.float32)
        return model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache)[0].numpy()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_moe_artifact_round_trip(tmp_path, direction):
    cfg, jmodel, model = models("deepseek_moe_16b", "capacity")
    p = np_params(jmodel, seed=6)
    if direction == "jax_to_torch":
        src = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=cfg)
        src.save(str(tmp_path))
        dst = QuantizedArtifact.load(str(tmp_path), verify=True)
        jart, tart = src, dst
    else:
        src = rtn_artifact(params_from_numpy(p, device="cpu"), 4, None, cfg=cfg)
        src.save(str(tmp_path))
        dst = JArtifact.load(str(tmp_path), verify=True)
        jart, tart = dst, src
    assert tart.manifest["content_digest"] == jart.manifest["content_digest"]
    assert tart.manifest["checksums"] == jart.manifest["checksums"]
    toks = tokens(cfg.vocab, 2, 8, seed=2)
    close(prefill_logits(model, tart.params, toks, "torch"),
          prefill_logits(jmodel, jart.params, toks, "jax"))


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_moe_decode_never_dequantizes_experts(monkeypatch, impl):
    """Decode runs the grouped tier on the stacked codes: no expert node
    goes through ``dequant_leaf``, and the plain grouped version keeps one
    expert's (K, N) at a time (never the (E, K, N) dense reference)."""
    cfg, jmodel, model = models("deepseek_moe_16b", impl)
    art = rtn_artifact(params_from_numpy(np_params(jmodel, seed=7), device="cpu"), 4,
                       None, cfg=cfg)
    calls = []
    orig = pack.dequant_leaf
    monkeypatch.setattr(pack, "dequant_leaf",
                        lambda *a, **k: (calls.append(a), orig(*a, **k))[1])

    def dense_ref(*a):
        raise AssertionError("decode reached the (E, K, N) dense reference")

    monkeypatch.setattr(ops, "qmm_grouped_dense_ref", dense_ref)
    ops.reset_tier_counts()
    cache = model.init_cache(2, 12, torch.float32)
    with torch.inference_mode():
        logits, _ = model.decode_step(art.params, torch.zeros((2, 1), dtype=torch.int32),
                                      cache, torch.full((2,), 8, dtype=torch.int32),
                                      art.hook())
    assert not calls and bool(torch.isfinite(logits).all())
    assert ops.TIER_COUNTS["grouped"] == 3 * (cfg.n_layers - cfg.moe.first_k_dense)
    ops.reset_tier_counts()
