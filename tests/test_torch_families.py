"""Shared helpers (no tests) of the port's parity tests for the attention
families (``test_torch_encdec.py``, ``test_torch_vlm.py``,
``test_torch_dense_cfgs.py``) and the recurrent ones
(``test_torch_recurrent.py``): numpy-made params carried into both
packages, the stub-modality inputs, and prefill + greedy decode through
both.

The JAX package starts every cross-attention gate at 0, so at its init a
model's logits do not depend on the memory at all (the frames, the
patches). The params here set every ``xgate`` to ``XGATE`` instead, so
the tests see the cross-attention and the encoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import get_model as j_get_model
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model

TOL = 1e-4
XGATE = 1.0
# the SSM's f32 leaves near JAX's init (A = -(1..n), D 1, conv weights of
# 0.1) with spread, and dt_bias so that dt = softplus(. - 2) is ~0.1: a state
# that remembers a few dozen steps
RECURRENT_FP = {
    "A_log": lambda rng, s: (np.log(np.arange(1, s[-1] + 1)) + 0.1 * rng.standard_normal(s)
                             ).astype(np.float32),
    "D": lambda rng, s: (1.0 + 0.1 * rng.standard_normal(s)).astype(np.float32),
    "dt_bias": lambda rng, s: (-2.0 + 0.5 * rng.standard_normal(s)).astype(np.float32),
    "conv_w": lambda rng, s: (0.3 * rng.standard_normal(s)).astype(np.float32),
}


def models(arch):
    jcfg, jmodel = j_get_model(arch, reduced=True)
    cfg, model = get_model(arch, reduced=True)
    return cfg, jmodel, model


def np_params(jmodel, seed=0, xgate=XGATE, w_scale=1.0):
    """Params of ``jmodel``'s layout made with numpy: norms near 1, tables,
    biases and ``enc_pos`` normal, linear weights uniform in
    +-w_scale/sqrt(fan_in), every ``xgate`` at ``xgate``."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "xgate":
            return np.full(s.shape, xgate, np.float32)
        if name in RECURRENT_FP:
            return RECURRENT_FP[name](rng, s.shape)
        if name == "g":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("table", "enc_pos") or len(s.shape) < 2:
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        lim = w_scale / np.sqrt(s.shape[-2])
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def both(p, bits=None):
    """(jax params, torch CPU params), RTN-packed at ``bits`` when given."""
    from repro.deploy import pack as jpack
    from repro_torch.deploy import pack as tpack

    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    if bits is not None:
        jp = jax.jit(jpack.quantize_tree, static_argnums=(1, 2))(jp, bits, None)
        tp = tpack.quantize_tree(tp, bits, None)
    return jp, tp


def np_batch(cfg, b, s, seed=1, s_enc=None):
    """Tokens (b, s), and a VLM's patches or an encoder-decoder model's
    frames (b, s_enc or s, d_model), from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.normal(size=(b, s_enc or s, cfg.d_model)).astype(np.float32)
    return out


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol)


def forward_both(jmodel, model, jp, tp, batch):
    jl, _ = jmodel.forward(jp, jb(batch), remat="none")
    with torch.no_grad():
        tl, _ = model.forward(tp, tb(batch))
    return tl.numpy(), np.asarray(jl)


def greedy_both(jmodel, model, jp, tp, batch, steps=4, jquant=None, quant=None):
    """Prefill ``batch`` in both packages, then ``steps`` greedy decode
    steps, each package on its own tokens. Returns the per-step logits
    (port, JAX), (B, steps + 1, V), and the greedy tokens (port, JAX)."""
    from repro.models.common import NO_QUANT as J_NO_QUANT
    from repro_torch.models.common import NO_QUANT

    jquant = jquant or J_NO_QUANT
    quant = quant or NO_QUANT
    b, s = batch["tokens"].shape
    jc = jmodel.init_cache(b, s + steps + 1, jnp.float32)
    jl, jc = jax.jit(lambda p, bt, c: jmodel.prefill(p, bt, c, jquant, remat="none"))(
        jp, jb(batch), jc)
    jstep = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos, jquant))
    with torch.inference_mode():
        tc = model.init_cache(b, s + steps + 1, torch.float32, "cpu")
        tl, tc = model.prefill(tp, tb(batch), tc, quant)
    jlog, tlog = [np.asarray(jl)], [tl.numpy()]
    jtok = [np.asarray(jnp.argmax(jl, -1)).astype(np.int32)]
    ttok = [tl.argmax(-1).numpy().astype(np.int32)]
    for i in range(steps):
        pos = np.full((b,), s + i, np.int32)
        jl, jc = jstep(jp, jnp.asarray(jtok[-1][:, None]), jc, jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = model.decode_step(tp, torch.from_numpy(ttok[-1][:, None]), tc,
                                       torch.from_numpy(pos), quant)
        jlog.append(np.asarray(jl))
        tlog.append(tl.numpy())
        jtok.append(np.asarray(jnp.argmax(jl, -1)).astype(np.int32))
        ttok.append(tl.argmax(-1).numpy().astype(np.int32))
    return ((np.stack(tlog, 1), np.stack(jlog, 1)),
            (np.stack(ttok, 1), np.stack(jtok, 1)))


def decode_matches_forward(model, params, batch):
    """The port's prefill of S-1 tokens, then one decode step, against its
    full forward at the same positions (``test_models_smoke.py``'s
    cache-correctness invariant, at its tolerances)."""
    t = tb(batch)
    B, S = t["tokens"].shape
    with torch.inference_mode():
        full, _ = model.forward(params, t)
        prompt = {k: (v[:, :S - 1] if k == "tokens" else v) for k, v in t.items()}
        cache = model.init_cache(B, 64, torch.float32, "cpu")
        lp, cache = model.prefill(params, prompt, cache)
        ld, _ = model.decode_step(params, t["tokens"][:, S - 1:S], cache,
                                  torch.full((B,), S - 1, dtype=torch.int32))
    np.testing.assert_allclose(lp.numpy(), full[:, S - 2].numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(ld.numpy(), full[:, S - 1].numpy(), rtol=3e-2, atol=3e-2)
    return lp, ld, full
