"""Port parity: the VLM family (reduced llama-3.2-vision-90b: groups of
self-attention layers closed by a tanh-gated cross-attention layer over
the patches) against the JAX package, on the CPU.

The same numpy-made params (every gate at 1.0, not JAX's init of 0, so
the logits depend on the patches) go through both packages: forward
logits within 1e-4, prefill + greedy decode tokens identical (FP and
packed W4), the cache invariant, the serve CLI's fixed batch token for
token, artifacts across packages with equal digests, ``arch_extras_fn``
value for value, and BRECQ with ``calib_bs == N`` and f32 streams: the
same units, every unit's reconstruction MSE within 1e-4, codes identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ReconConfig as JReconConfig
from repro.core import quantize as jquantize
from repro.data import Corpus as JCorpus
from repro.data import CorpusConfig as JCorpusConfig
from repro.data import make_batches as jmake_batches
from repro.data.synthetic import arch_extras_fn as j_arch_extras_fn
from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import export as jexport
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.launch import serve as jserve
from repro_torch.core import ReconConfig, quantize
from repro_torch.core.quantizer import quantize_int
from repro_torch.data import Corpus, CorpusConfig, arch_extras_fn, make_batches
from repro_torch.deploy import QuantizedArtifact, export
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import attention as attn_mod
from test_torch_families import (TOL, both, close, decode_matches_forward, forward_both,
                                 greedy_both, jb, models, np_batch, np_params, tb)

ARCH = "llama32_vision_90b"


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, model = models(ARCH)
    assert [s.mixer for s in model.stacks[0].subs] == ["attn", "xattn"]
    assert model.stacks[0].n == 2
    return cfg, jmodel, model, np_params(jmodel)


def test_forward_and_loss_match_jax(pair):
    cfg, jmodel, model, p = pair
    jp, tp = both(p)
    batch = np_batch(cfg, 2, 16)
    got, want = forward_both(jmodel, model, jp, tp, batch)
    close(got, want)
    with torch.no_grad():
        loss = model.loss(tp, tb(batch))
    close(float(loss), float(jmodel.loss(jp, jb(batch), remat="none")))


def test_logits_depend_on_the_patches(pair):
    cfg, jmodel, model, p = pair
    _, tp = both(p)
    a = np_batch(cfg, 2, 16, seed=1)
    b = dict(a, patches=np_batch(cfg, 2, 16, seed=9)["patches"])
    with torch.no_grad():
        la, lb = (model.forward(tp, tb(x))[0] for x in (a, b))
    assert float((la - lb).abs().max()) > 100 * TOL * float(la.abs().max())


@pytest.mark.parametrize("gate,caught", [(0.0, False), (1.0, True)])
def test_zeroed_cross_attention_is_caught_only_with_the_gate_open(pair, monkeypatch,
                                                                  gate, caught):
    cfg, jmodel, model, _ = pair
    orig = attn_mod.apply

    def no_cross(ctx, p, spec, x, kv_x=None, kv_pos=None):
        out = orig(ctx, p, spec, x, kv_x, kv_pos)
        return out if kv_x is None else torch.zeros_like(out)

    monkeypatch.setattr(attn_mod, "apply", no_cross)
    jp, tp = both(np_params(jmodel, xgate=gate))
    got, want = forward_both(jmodel, model, jp, tp, np_batch(cfg, 2, 16))
    assert (float(np.abs(got - want).max()) > 100 * TOL) == caught


@pytest.mark.parametrize("bits", [None, 4])
def test_prefill_and_greedy_decode_match_jax(pair, bits):
    cfg, jmodel, model, p = pair
    jp, tp = both(p, bits)
    (tl, jl), (tt, jt) = greedy_both(jmodel, model, jp, tp, np_batch(cfg, 2, 12), steps=4)
    close(tl, jl)
    np.testing.assert_array_equal(tt, jt)


def test_decode_matches_forward(pair):
    cfg, _, model, p = pair
    _, tp = both(p)
    decode_matches_forward(model, tp, np_batch(cfg, 2, 24))


def test_arch_extras_match_jax(pair):
    cfg = pair[0]
    got = arch_extras_fn(cfg)(3, 10, 5)
    want = j_arch_extras_fn(cfg)(3, 10, 5)
    assert list(got) == list(want) == ["patches"]
    assert got["patches"].shape == (3, cfg.n_patches, cfg.d_model)
    np.testing.assert_array_equal(got["patches"].numpy(), np.asarray(want["patches"]))


def test_serve_fixed_batch_matches_jax(pair, tmp_path):
    """``serve --quant 4`` with the same params: identical greedy tokens
    on the CLI's patches, byte-identical artifacts; ``--engine`` raises on
    the cross-attention layer, as JAX's does."""
    cfg, _, _, p = pair
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen-len", "4", "--no-compare-fp", "--quant", "4"]
    jgen = np.asarray(jserve.main([*argv, "--save-artifact", str(tmp_path / "j")],
                                  params=jax.tree.map(jnp.asarray, p)))
    out = serve.main([*argv, "--save-artifact", str(tmp_path / "t"), "--device", "cpu"],
                     params=params_from_numpy(p, device="cpu"))
    np.testing.assert_array_equal(out["tokens"].numpy(), jgen)
    tm = QuantizedArtifact.load(str(tmp_path / "t")).manifest
    jm = JArtifact.load(str(tmp_path / "j")).manifest
    assert tm["content_digest"] == jm["content_digest"]
    assert tm["family"] == jm["family"] == "vlm"
    with pytest.raises(ValueError, match="attention-only"):
        serve.main([*argv, "--engine", "--device", "cpu"])


def test_jax_artifact_serves_in_the_port(pair, tmp_path):
    cfg, jmodel, model, p = pair
    jart = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=cfg)
    jart.save(str(tmp_path))
    got = QuantizedArtifact.load(str(tmp_path), verify=True)
    np.testing.assert_array_equal(got.params["body"]["sub1"]["xgate"].numpy(),
                                  p["body"]["sub1"]["xgate"])
    _, (tt, jt) = greedy_both(jmodel, model, jart.params, got.params,
                              np_batch(cfg, 2, 8), steps=3,
                              jquant=jart.hook(), quant=got.hook())
    np.testing.assert_array_equal(tt, jt)


KW = dict(w_bits=2, iters=6, calib_bs=8, stream_dtype="float32", use_fisher=True)


@pytest.fixture(scope="module")
def runs(pair):
    cfg, jmodel, model, p = pair
    jp, tp = both(p)
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1,
                         extras_fn=j_arch_extras_fn(cfg))
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1,
                       extras_fn=arch_extras_fn(cfg))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = quantize(model, tp, cal, ReconConfig(**KW))
    finally:
        torch.set_num_threads(n)
    jres = jquantize(jmodel, jp, jcal, JReconConfig(**KW))
    return cfg, jmodel, model, res, jres


def test_brecq_matches_jax(runs):
    cfg, jmodel, model, res, jres = runs
    assert res.stats["n_units"] == jres.stats["n_units"] == 2
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["unit"] == list(ju["unit"]) and tu["retries"] == ju["retries"] == 0
        for k in ("final_recon_mse", "rtn_recon_mse"):
            np.testing.assert_allclose(tu[k], float(ju[k]), rtol=1e-4)
    assert set(res.v) == set(jres.v)
    assert any("/sub1/attn/wk" in p for p in res.v)  # the cross-attention's K over patches
    for path in res.v:
        st, qc = res.qstates[path]
        sname, ri = path.split("/")[0].rsplit(".", 1)
        node, jnode = res.params_q[sname], jres.params_q[sname]
        for k in path.split("/")[1:]:
            node, jnode = node[k], jnode[k]
        jst = type(st)(torch.from_numpy(np.array(jres.qstates[path][0].scale)),
                       torch.from_numpy(np.array(jres.qstates[path][0].zero_point)))
        np.testing.assert_array_equal(
            quantize_int(node["w"][int(ri)], st, qc).numpy(),
            quantize_int(torch.from_numpy(np.array(jnode["w"][int(ri)])), jst, qc).numpy(),
            err_msg=path)


def test_brecq_export_loads_in_jax(runs, tmp_path):
    cfg, jmodel, model, res, jres = runs
    export(model, res).save(str(tmp_path))
    got = JArtifact.load(str(tmp_path))
    want = jexport(jmodel, jres)
    assert got.manifest["bits_by_path"] == want.manifest["bits_by_path"]
    assert got.manifest["family"] == "vlm"
    batch = np_batch(cfg, 2, 8)
    logits, _ = jmodel.forward(got.params, jb(batch), got.hook(), remat="none")
    ref, _ = jmodel.forward(want.params, jb(batch), want.hook(), remat="none")
    close(logits, ref)
