"""Port parity: the dense LM (repro_torch.models) vs the JAX package.

The same numpy-made params go through both packages; FP logits, prefill
logits and decode-step logits must agree to 1e-4 (f32, sums in another
order). Covered: reduced brecq-lm-100m (tied embeddings), reduced
tinyllama-1.1b (GQA, untied head; packed, its 8-bit head runs through
qmm), and a sliding-window variant whose prompt overflows the ring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import pack as jpack
from repro.models import get_model as j_get_model
from repro.models.transformer import LM as JLM
from repro_torch.deploy import pack as tpack
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.models.transformer import LM

TOL = 1e-4


def np_params(jmodel, seed=0):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "g":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "table" or len(s.shape) < 2:  # embedding, norm biases
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        lim = 1.0 / np.sqrt(s.shape[-2])
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def models(arch, **overrides):
    jcfg, jmodel = j_get_model(arch, reduced=True)
    cfg, model = get_model(arch, reduced=True)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        cfg = dataclasses.replace(cfg, **overrides)
        jmodel, model = JLM(jcfg), LM(cfg)
    return cfg, jmodel, model


def tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def both(p, bits=None):
    """(jax params, torch params), RTN-packed at ``bits`` when given."""
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    if bits is not None:
        jp = jax.jit(jpack.quantize_tree, static_argnums=(1, 2))(jp, bits, None)
        tp = tpack.quantize_tree(tp, bits, None)
    return jp, tp


@pytest.mark.parametrize("arch", ["brecq_lm_100m", "tinyllama_1_1b"])
def test_fp_logits_and_loss_match_jax(arch):
    cfg, jmodel, model = models(arch)
    jp, tp = both(np_params(jmodel))
    toks = tokens(cfg.vocab, 2, 16)
    jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, remat="none")
    tl, aux = model.forward(tp, {"tokens": torch.from_numpy(toks)})
    close(tl, jl)
    assert float(aux) == 0.0
    jloss = jmodel.loss(jp, {"tokens": jnp.asarray(toks)}, remat="none")
    tloss = model.loss(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL, atol=TOL)


def _serve_both(cfg, jmodel, model, jp, tp, b=2, s=12, steps=3, max_len=20):
    toks = tokens(cfg.vocab, b, s)
    jc = jmodel.init_cache(b, max_len, jnp.float32)
    tc = model.init_cache(b, max_len, torch.float32)
    jl, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, {"tokens": t}, c, remat="none"))(
        jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    close(tl, jl)
    close(tc["body"]["sub0"]["attn"]["k"], jc["body"]["sub0"]["attn"]["k"])
    np.testing.assert_array_equal(tc["body"]["sub0"]["attn"]["pos"].numpy(),
                                  np.asarray(jc["body"]["sub0"]["attn"]["pos"]))
    jstep = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(steps):
        pos = np.full((b,), s + i, np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = model.decode_step(tp, torch.from_numpy(tok), tc,
                                       torch.from_numpy(pos))
        close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ["brecq_lm_100m", "tinyllama_1_1b"])
def test_prefill_and_decode_match_jax(arch):
    cfg, jmodel, model = models(arch)
    jp, tp = both(np_params(jmodel))
    _serve_both(cfg, jmodel, model, jp, tp)


@pytest.mark.parametrize("arch,bits", [("brecq_lm_100m", 4), ("tinyllama_1_1b", 4),
                                       ("tinyllama_1_1b", 2)])
def test_packed_prefill_and_decode_match_jax(arch, bits):
    """Packed params: every linear (and tinyllama's untied 8-bit head)
    runs through qmm's prefill and decode tiers."""
    cfg, jmodel, model = models(arch)
    jp, tp = both(np_params(jmodel), bits)
    if arch == "tinyllama_1_1b":
        assert tp["head"]["w"].dtype == torch.int8 and "qscale" in tp["head"]
    _serve_both(cfg, jmodel, model, jp, tp)


def test_sliding_window_ring_matches_jax():
    """window 8 < prompt 12: prefill keeps the tail in a ring buffer."""
    cfg, jmodel, model = models("brecq_lm_100m", window=8)
    jp, tp = both(np_params(jmodel, seed=2))
    _serve_both(cfg, jmodel, model, jp, tp, s=12, steps=4)


def test_local_global_stack_matches_jax():
    cfg, jmodel, model = models("brecq_lm_100m", local_global=(1, 1), local_window=4)
    assert [len(s.subs) for s in model.stacks] == [2]
    jp, tp = both(np_params(jmodel, seed=3))
    _serve_both(cfg, jmodel, model, jp, tp, s=8, steps=2)


def test_other_families_name_their_slice():
    """The recurrent families build with JAX's stack layout (xLSTM: blocks
    of mLSTM sub-layers closed by an sLSTM one; hymba: one hybrid sub-layer
    with an MLP); an unknown family raises ValueError, an unknown arch
    KeyError."""
    from repro.models import get_config as j_get_config
    from repro.models.transformer import build_stacks as j_build_stacks
    from repro_torch.configs.base import ArchConfig

    def layout(stacks):
        return [(s.name, s.n, [(u.mixer, u.window, u.ffn) for u in s.subs]) for s in stacks]

    cfg = ArchConfig(name="x", family="ssm", n_layers=2, d_model=8, n_heads=2,
                     n_kv_heads=2, d_ff=8, vocab=16, slstm_every=2)
    assert layout(LM(cfg).stacks) == [("body", 1, [("mlstm", None, None),
                                                   ("slstm", None, None)])]
    for arch in ("hymba_1_5b", "xlstm_350m"):
        _, model = get_model(arch)
        assert layout(model.stacks) == layout(j_build_stacks(j_get_config(arch)))
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(cfg, family="rwkv"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_model("mamba_130m")


def test_init_layout_matches_jax():
    cfg, jmodel, model = models("tinyllama_1_1b")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    p = model.init(torch.Generator().manual_seed(0))
    want = {"/".join(str(k.key) for k in path): (tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    from repro_torch.interop import flatten_paths

    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten_paths(p).items()}
    assert got == want


# ---------------------------------------------------------------------------
# building blocks (repro_torch.models.common) vs repro.models.common
# ---------------------------------------------------------------------------

from repro.models import common as jcm  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 4, 16)
    g, b = _rand(rng, 16), _rand(rng, 16)
    close(tcm.rmsnorm({"g": torch.from_numpy(g)}, torch.from_numpy(x)),
          jcm.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)))
    close(tcm.layernorm({"g": torch.from_numpy(g), "b": torch.from_numpy(b)},
                        torch.from_numpy(x)),
          jcm.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x)))
    pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
    close(tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0),
          jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(1)
    logits = _rand(rng, 2, 6, 11) * 3
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = tcm.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        want = jcm.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_mha_and_causal_mask_match_jax(window):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 6, 4, 8), _rand(rng, 2, 6, 2, 8), _rand(rng, 2, 6, 2, 8)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    tmask = tcm.causal_mask(torch.from_numpy(pos), torch.from_numpy(pos), window)
    jmask = jcm.causal_mask(jnp.asarray(pos), jnp.asarray(pos), window)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    close(tcm.mha(*map(torch.from_numpy, (q, k, v)), tmask),
          jcm.mha(*map(jnp.asarray, (q, k, v)), jmask))


@pytest.mark.parametrize("window,iota", [(None, True), (5, True), (None, False), (5, False)])
def test_chunked_attention_multi_chunk_matches_jax(window, iota):
    """Several q and kv chunks: the triangle skip (iota) and the full loop."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 16, 4, 8), _rand(rng, 2, 16, 2, 8), _rand(rng, 2, 16, 2, 8)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    kw = dict(causal=True, window=window, q_chunk=4, kv_chunk=4, iota_pos=iota)
    close(tcm.chunked_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), **kw),
          jcm.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)), **kw))


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attend_matches_jax(window):
    rng = np.random.default_rng(4)
    q = _rand(rng, 2, 2, 4, 8)
    kc, vc = _rand(rng, 2, 10, 2, 8), _rand(rng, 2, 10, 2, 8)
    kpos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    kpos[:, 8:] = -1  # empty slots
    cur = np.array([[6, 7], [6, 7]], np.int32)
    close(tcm.decode_attend(*map(torch.from_numpy, (q, kc, vc, kpos, cur)), window=window),
          jcm.decode_attend(*map(jnp.asarray, (q, kc, vc, kpos, cur)), window=window))


def test_layernorm_gelu_model_matches_jax():
    """norm='ln' and mlp_kind='gelu' (tanh approximation, as jax.nn.gelu)."""
    cfg, jmodel, model = models("brecq_lm_100m", norm="ln", mlp_kind="gelu")
    jp, tp = both(np_params(jmodel, seed=5))
    toks = tokens(cfg.vocab, 2, 8)
    jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, remat="none")
    tl, _ = model.forward(tp, {"tokens": torch.from_numpy(toks)})
    close(tl, jl)
