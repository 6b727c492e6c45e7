"""Port parity: the recurrent families, reduced hymba-1.5b (``hybrid``:
sliding-window attention and a selective SSM on the same input, averaged,
then an MLP) and reduced xlstm-350m (``ssm``: blocks of 2 mLSTM + 1 sLSTM
sub-layers), against the JAX package, on the CPU.

The same numpy-made params go through both packages. Forward logits and
loss, prefill and every greedy decode step's logits within 1e-4 (hymba's
prompts of 40-48 tokens pass its window of 32, so the ring binds); greedy
tokens identical, FP and packed W4/W2, through the models and through the
serve CLI's fixed batch; the port's decode against its own forward, step by
step, within 1e-4 (the state written in place at prefill and at every
step); BRECQ with ``calib_bs == N`` and f32 streams: the same units, every
unit's reconstruction MSE within 1e-4, codes identical; the Fisher at every
block within 1e-4; artifacts across packages with equal digests, both
ways. The engine rejects both ("attention-only"), and a decode step of
more than one token raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ReconConfig as JReconConfig
from repro.core import quantize as jquantize
from repro.core.fisher import FisherStream as JFisherStream
from repro.core.reconstruction import Walker as JWalker
from repro.data import Corpus as JCorpus
from repro.data import CorpusConfig as JCorpusConfig
from repro.data import make_batches as jmake_batches
from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import export as jexport
from repro.deploy import pack as jpack
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.launch import serve as jserve
from repro.models.transformer import build_stacks as j_build_stacks
from repro_torch.core import ReconConfig, quantize, reconstruction
from repro_torch.core.fisher import FisherStream
from repro_torch.core.quantizer import quantize_int
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.deploy import QuantizedArtifact, export, rtn_artifact
from repro_torch.deploy import pack as tpack
from repro_torch.interop import flatten_paths, params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import get_config, get_model
from repro_torch.models.transformer import build_stacks
from test_torch_families import (TOL, both, close, forward_both, greedy_both, jb, models,
                                 np_batch, np_params, tb)

ARCHS = ["hymba_1_5b", "xlstm_350m"]
# (prompt, forward) lengths: hymba's pass its window of 32
LENS = {"hymba_1_5b": (40, 48), "xlstm_350m": (16, 24)}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, jmodel, model = models(request.param)
    return request.param, cfg, jmodel, model, np_params(jmodel)


def _stack_layout(stacks):
    return [(s.name, s.n, [(sub.mixer, sub.window, sub.ffn) for sub in s.subs])
            for s in stacks]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_build_with_jax_stack_layout(arch, reduced):
    from repro.models import get_config as j_get_config

    cfg, model = get_model(arch, reduced=reduced)
    assert _stack_layout(model.stacks) == _stack_layout(
        j_build_stacks(j_get_config(arch, reduced=reduced)))
    assert model.recurrent
    if arch == "xlstm_350m" and not reduced:
        assert _stack_layout(model.stacks) == [
            ("body", 4, [("mlstm", None, None)] * 5 + [("slstm", None, None)])]
    if arch == "hymba_1_5b" and not reduced:
        assert _stack_layout(model.stacks) == [("body", 32, [("hymba", 2048, "mlp")])]


def test_init_layout_matches_jax(pair):
    _, cfg, jmodel, model, _ = pair
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): (tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten_paths(model.init(torch.Generator().manual_seed(0))).items()}
    assert got == want


def test_unknown_families_and_uneven_blocks_raise():
    cfg = get_config("xlstm_350m", reduced=True)
    with pytest.raises(ValueError, match="unknown family 'rwkv'"):
        build_stacks(dataclasses.replace(cfg, family="rwkv"))
    with pytest.raises(ValueError, match="blocks of 2 mLSTM"):
        build_stacks(dataclasses.replace(cfg, n_layers=5))


def test_forward_and_loss_match_jax(pair):
    arch, cfg, jmodel, model, p = pair
    jp, tp = both(p)
    batch = np_batch(cfg, 2, LENS[arch][1])
    got, want = forward_both(jmodel, model, jp, tp, batch)
    close(got, want)
    with torch.no_grad():
        loss = model.loss(tp, tb(batch))
    close(float(loss), float(jmodel.loss(jp, jb(batch), remat="none")))


@pytest.mark.parametrize("bits", [None, 4, 2])
def test_prefill_and_greedy_decode_match_jax(pair, bits):
    """Prefill, then 6 greedy steps, each package on its own tokens and its
    own state: a step that lost its state diverges from JAX's."""
    arch, cfg, jmodel, model, p = pair
    jp, tp = both(p, bits)
    (tl, jl), (tt, jt) = greedy_both(jmodel, model, jp, tp,
                                     np_batch(cfg, 2, LENS[arch][0]), steps=6)
    close(tl, jl)
    np.testing.assert_array_equal(tt, jt)


def decode_against_forward(model, params, tokens, k, quant=None):
    """Prefill S - k tokens, then k decode steps of the forward's tokens:
    the largest |logit| difference at each of the k + 1 positions."""
    from repro_torch.models.common import NO_QUANT

    quant = quant or NO_QUANT
    B, S = tokens.shape
    with torch.inference_mode():
        full, _ = model.forward(params, {"tokens": tokens}, quant)
        cache = model.init_cache(B, S, torch.float32, tokens.device)
        lg, cache = model.prefill(params, {"tokens": tokens[:, :S - k]}, cache, quant)
        errs = [float((lg - full[:, S - k - 1]).abs().max())]
        for t in range(S - k, S):
            pos = torch.full((B,), t, dtype=torch.int32, device=tokens.device)
            lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache, pos, quant)
            errs.append(float((lg - full[:, t]).abs().max()))
    return errs, float(full.abs().max())


def test_decode_matches_forward_step_by_step(pair):
    arch, cfg, jmodel, model, p = pair
    _, tp = both(p)
    tokens = tb(np_batch(cfg, 2, LENS[arch][1]))["tokens"]
    errs, amax = decode_against_forward(model, tp, tokens, 8)
    assert max(errs) <= TOL * max(amax, 1.0), errs


def test_decode_step_of_several_tokens_raises(pair):
    """JAX's recurrent step reads the chunk's first token only; the port
    refuses the chunk."""
    arch, cfg, jmodel, model, p = pair
    _, tp = both(p)
    cache = model.init_cache(2, 32, torch.float32, "cpu")
    toks = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="3 tokens a row; a recurrent mixer"):
        model.decode_step(tp, toks, cache, torch.zeros((2,), dtype=torch.int32))


def test_short_prompt_raises_where_the_conv_state_needs_more():
    cfg, jmodel, model = models("hymba_1_5b")
    _, tp = both(np_params(jmodel))
    cache = model.init_cache(2, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        model.prefill(tp, {"tokens": torch.zeros((2, 2), dtype=torch.int32)}, cache)


@pytest.mark.parametrize("bits", [None, 4, 2])
def test_serve_fixed_batch_matches_jax_cli(pair, bits):
    """``serve`` (FP, or a fresh RTN artifact saved, reloaded and served
    packed) token for token against the JAX CLI on the same params; weights
    at 3x their init range so that the tokens vary."""
    arch, cfg, jmodel, model, _ = pair
    p = np_params(jmodel, seed=2, w_scale=3.0)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            str(LENS[arch][0]), "--gen-len", "5", "--no-compare-fp"]
    if bits:
        argv += ["--quant", str(bits)]
    out = serve.main([*argv, "--device", "cpu"], params=params_from_numpy(p, device="cpu"))
    want = np.asarray(jserve.main(argv, params=jax.tree.map(jnp.asarray, p)))
    got = out["tokens"].numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2


def test_engine_rejects_recurrent_mixers(pair):
    arch = pair[0]
    with pytest.raises(ValueError, match="attention-only"):
        serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                    "--gen-len", "4", "--quant", "4", "--engine", "--device", "cpu"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rtn_artifacts_cross_packages(pair, tmp_path, direction):
    """Every dense leaf packed (the SSM's wB/wC/w_dt, the mLSTM's w_if, the
    sLSTM's w_in, the untied head); the f32 leaves pass through unpacked."""
    arch, cfg, jmodel, model, p = pair
    jart = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=cfg)
    tart = rtn_artifact(params_from_numpy(p, device="cpu"), 4, None, cfg=cfg)
    assert tpack.content_digest(tpack.tree_checksums(tart.params)) == \
        jpack.content_digest(jpack.tree_checksums(jart.params))
    packed = {k for k, v in flatten_paths(tart.params).items() if v.dtype == torch.int8}
    fp_leaves = ({"A_log", "D", "dt_bias", "conv_w"} if arch == "hymba_1_5b"
                 else {"out_norm/g"})
    for k, v in flatten_paths(tart.params).items():
        if any(k.endswith(f) for f in fp_leaves):
            assert v.dtype == torch.float32, k
    want = ({"ssm/wB/w", "ssm/wC/w", "ssm/w_dt/w", "ssm/in_proj/w", "ssm/out_proj/w"}
            if arch == "hymba_1_5b" else {"mix/w_if/w", "mix/w_in/w", "mix/wq/w"})
    assert all(any(k.endswith(w) for k in packed) for w in want) and "head/w" in packed
    if direction == "jax_to_port":
        jart.save(str(tmp_path))
        got = QuantizedArtifact.load(str(tmp_path), verify=True)
        g, w = flatten_paths(params_to_numpy(got.params)), flatten_paths(p)
        for k in w:
            if any(k.endswith(f) for f in fp_leaves):
                np.testing.assert_array_equal(g[k], w[k])  # passed through unpacked
        batch = np_batch(cfg, 2, 8)
        with torch.no_grad():
            logits, _ = model.forward(got.params, tb(batch), got.hook())
        ref, _ = jmodel.forward(jart.params, jb(batch), jart.hook(), remat="none")
        close(logits.numpy(), ref)
    else:
        tart.save(str(tmp_path))
        got = JArtifact.load(str(tmp_path), verify=True)
        jart.save(str(tmp_path / "j"))
        want_m = JArtifact.load(str(tmp_path / "j")).manifest
        assert got.manifest["checksums"] == want_m["checksums"]
        assert got.manifest["content_digest"] == want_m["content_digest"]
        assert got.manifest["family"] == cfg.family


# ---------------------------------------------------------------------------
# calibration through the recurrent blocks
# ---------------------------------------------------------------------------

KW = dict(w_bits=2, iters=6, calib_bs=8, stream_dtype="float32", use_fisher=True)


@pytest.fixture(scope="module")
def runs(pair):
    """BRECQ W2 in both packages on 2 batches of 4 x 16 tokens (N = 8 =
    calib_bs)."""
    arch, cfg, jmodel, model, p = pair
    jp, tp = both(p)
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1)
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1)
    for j, t in zip(jcal, cal):
        np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = quantize(model, tp, cal, ReconConfig(**KW))
    finally:
        torch.set_num_threads(n)
    jres = jquantize(jmodel, jp, jcal, JReconConfig(**KW))
    return arch, cfg, jmodel, model, jp, tp, jcal, cal, res, jres


def test_brecq_matches_jax(runs):
    arch, cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    n_blocks = sum(s.n for s in model.stacks)
    assert res.stats["n_units"] == jres.stats["n_units"] == n_blocks
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["unit"] == list(ju["unit"]) and tu["retries"] == ju["retries"] == 0
        for k in ("final_recon_mse", "rtn_recon_mse"):
            np.testing.assert_allclose(tu[k], float(ju[k]), rtol=1e-4)
    assert set(res.v) == set(jres.v) and set(res.qstates) == set(jres.qstates)
    mixer_paths = ("ssm/wB", "ssm/w_dt") if arch == "hymba_1_5b" else ("mix/w_if", "mix/w_in")
    assert all(any(m in p for p in res.v) for m in mixer_paths)
    for path, (st, qc) in res.qstates.items():
        if path in ("embed/table", "head/w"):
            continue
        sname, ri = path.split("/")[0].rsplit(".", 1)
        node, jnode = res.params_q[sname], jres.params_q[sname]
        for k in path.split("/")[1:]:
            node, jnode = node[k], jnode[k]
        got = quantize_int(node["w"][int(ri)], st, qc)
        jst = type(st)(torch.from_numpy(np.array(jres.qstates[path][0].scale)),
                       torch.from_numpy(np.array(jres.qstates[path][0].zero_point)))
        want = quantize_int(torch.from_numpy(np.array(jnode["w"][int(ri)])), jst, qc)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=path)


def test_brecq_export_loads_in_jax(runs, tmp_path):
    arch, cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    export(model, res).save(str(tmp_path))
    got = JArtifact.load(str(tmp_path))  # schema, crc32, digest
    want = jexport(jmodel, jres)
    assert got.manifest["bits_by_path"] == want.manifest["bits_by_path"]
    assert got.manifest["family"] == want.manifest["family"] == cfg.family
    batch = np_batch(cfg, 2, 8)
    logits, _ = jmodel.forward(got.params, jb(batch), got.hook(), remat="none")
    ref, _ = jmodel.forward(want.params, jb(batch), want.hook(), remat="none")
    close(logits, ref)


def test_fisher_through_the_recurrent_blocks_matches_jax(runs):
    """g^2 at every block output: the gradient crosses the later blocks'
    scans on its way back."""
    arch, cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    jf = JFisherStream(JWalker(jmodel), jp, jcal, mode="stream", dtype=jnp.float32)
    tf = FisherStream(reconstruction.Walker(model), tp, cal, mode="stream",
                      dtype=torch.float32)
    for bi in range(sum(s.n for s in model.stacks)):
        want = np.asarray(jf.for_block(bi))
        got = tf.for_block(bi).numpy()
        assert got.shape == want.shape == (8, 16, cfg.d_model)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
        assert float(np.abs(got).max()) > 0
