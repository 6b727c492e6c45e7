"""Port parity: the encoder-decoder family (reduced whisper-small,
``repro_torch.models.encdec``) against the JAX package, on the CPU.

The same numpy-made params (every cross-attention gate at 1.0, not JAX's
init of 0, so the decoder sees the encoder) go through both packages:
forward logits and ``encode`` within 1e-4, prefill + greedy decode tokens
identical (FP and packed W4), the cache invariant, artifacts across
packages with equal digests, ``arch_extras_fn`` value for value, BRECQ
(encoder units, the boundary, decoder units) with ``calib_bs == N`` and
f32 streams: the same units, every unit's reconstruction MSE within 1e-4,
codes identical; the Fisher at both sides of the boundary, and
``sensitivity.measure`` across it.
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
from repro.core.reconstruction import _partition as j_partition
from repro.data import Corpus as JCorpus
from repro.data import CorpusConfig as JCorpusConfig
from repro.data import make_batches as jmake_batches
from repro.data.synthetic import arch_extras_fn as j_arch_extras_fn
from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import export as jexport
from repro.deploy import pack as jpack
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.launch import serve as jserve
from repro_torch.core import ReconConfig, quantize, reconstruction
from repro_torch.core.fisher import FisherStream
from repro_torch.core.quantizer import quantize_int
from repro_torch.data import Corpus, CorpusConfig, arch_extras_fn, make_batches
from repro_torch.deploy import QuantizedArtifact, export, rtn_artifact
from repro_torch.deploy import pack as tpack
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import attention as attn_mod
from repro_torch.models.encdec import EncDecLM
from test_torch_families import (TOL, both, close, decode_matches_forward, forward_both,
                                 greedy_both, jb, models, np_batch, np_params, tb)
from torch_threads import one_torch_thread  # noqa: F401


ARCH = "whisper_small"


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, model = models(ARCH)
    assert isinstance(model, EncDecLM) and cfg.enc_dec
    return cfg, jmodel, model, np_params(jmodel)


def test_forward_encode_and_loss_match_jax(pair):
    cfg, jmodel, model, p = pair
    jp, tp = both(p)
    batch = np_batch(cfg, 2, 16, s_enc=24)
    got, want = forward_both(jmodel, model, jp, tp, batch)
    close(got, want)
    with torch.no_grad():
        mem = model.encode(tp, torch.from_numpy(batch["frames"]))
        loss = model.loss(tp, tb(batch))
    close(mem.numpy(), jmodel.encode(jp, jnp.asarray(batch["frames"]), remat="none"))
    close(float(loss), float(jmodel.loss(jp, jb(batch), remat="none")))
    # a given memory skips the encoder
    with torch.no_grad():
        again, _ = model.forward(tp, {"tokens": torch.from_numpy(batch["tokens"]),
                                      "memory": mem})
    np.testing.assert_array_equal(again.numpy(), got)


def test_logits_depend_on_the_frames(pair):
    cfg, jmodel, model, p = pair
    _, tp = both(p)
    a = np_batch(cfg, 2, 16, seed=1)
    b = dict(a, frames=np_batch(cfg, 2, 16, seed=9)["frames"])
    with torch.no_grad():
        la, lb = (model.forward(tp, tb(x))[0] for x in (a, b))
    assert float((la - lb).abs().max()) > 100 * TOL * float(la.abs().max())


def test_zeroed_cross_attention_is_caught_only_with_the_gate_open(pair, monkeypatch):
    """At JAX's init (every gate 0) a port whose cross-attention returns
    zeros still matches JAX to the bit; with the gates at 1.0, as these
    tests set them, it misses by far more than the tolerance."""
    cfg, jmodel, model, _ = pair
    batch = np_batch(cfg, 2, 16)
    orig = attn_mod.apply

    def no_cross(ctx, p, spec, x, kv_x=None, kv_pos=None):
        out = orig(ctx, p, spec, x, kv_x, kv_pos)
        return out if kv_x is None else torch.zeros_like(out)

    monkeypatch.setattr(attn_mod, "apply", no_cross)
    for gate, caught in ((0.0, False), (1.0, True)):
        jp, tp = both(np_params(jmodel, xgate=gate))
        got, want = forward_both(jmodel, model, jp, tp, batch)
        err = float(np.abs(got - want).max())
        assert (err > 100 * TOL) == caught, (gate, err)


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
    assert list(got) == list(want) == ["frames"]
    assert got["frames"].dtype == torch.float32 and got["frames"].shape == (3, 10, cfg.d_model)
    np.testing.assert_array_equal(got["frames"].numpy(), np.asarray(want["frames"]))


def test_serve_fixed_batch_matches_jax(pair, tmp_path):
    """``serve --quant 4``: the port's CLI ships JAX's artifact byte for
    byte (enc_pos, enc_norm and the gates pass through unpacked; the untied
    head is 8-bit), and its tokens are JAX's greedy tokens on that artifact
    and the CLI's batch. (JAX's own CLI cannot serve whisper: it compiles
    its decode step on the cross-attention cache of ``init_cache``, which
    its prefill replaces with the memory's length; ROADMAP 3.)"""
    cfg, jmodel, model, p = pair
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen-len", "4", "--no-compare-fp", "--quant", "4"]
    out = serve.main([*argv, "--save-artifact", str(tmp_path), "--device", "cpu"],
                     params=params_from_numpy(p, device="cpu"))
    jart = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=cfg)
    jart.save(str(tmp_path / "j"))
    tart = QuantizedArtifact.load(str(tmp_path))
    jm = JArtifact.load(str(tmp_path / "j")).manifest
    assert tart.manifest["content_digest"] == jm["content_digest"]
    assert tart.manifest["family"] == jm["family"] == "audio"
    batch = {k: v.numpy() for k, v in serve.fixed_batch(serve.parse_args(argv), cfg).items()}
    assert batch["frames"].shape == (2, 8, cfg.d_model)
    _, (tt, jt) = greedy_both(jmodel, model, jart.params, tart.params, batch, steps=3,
                              jquant=jart.hook(), quant=tart.hook())
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(out["tokens"].numpy(), jt)
    with pytest.raises(TypeError, match="xk"):
        jserve.main(argv, params=jax.tree.map(jnp.asarray, p))


def test_engine_rejects_cross_attention(pair):
    with pytest.raises(ValueError, match="attention-only"):
        serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
                    "--gen-len", "4", "--quant", "4", "--engine", "--device", "cpu"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rtn_artifacts_cross_packages(pair, tmp_path, direction):
    cfg, jmodel, model, p = pair
    jart = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=cfg)
    tart = rtn_artifact(params_from_numpy(p, device="cpu"), 4, None, cfg=cfg)
    assert tpack.content_digest(tpack.tree_checksums(tart.params)) == \
        jpack.content_digest(jpack.tree_checksums(jart.params))
    if direction == "jax_to_port":
        jart.save(str(tmp_path))
        got = QuantizedArtifact.load(str(tmp_path), verify=True)
        g = params_to_numpy(got.params)
        for a, want in ((g["enc_pos"], p["enc_pos"]), (g["enc_norm"]["g"], p["enc_norm"]["g"]),
                        (g["enc_norm"]["b"], p["enc_norm"]["b"]),
                        (g["dec"]["sub1"]["xgate"], p["dec"]["sub1"]["xgate"])):
            np.testing.assert_array_equal(a, want)  # passed through unpacked
        assert got.params["head"]["w"].dtype == torch.int8
        batch = np_batch(cfg, 2, 8)
        with torch.no_grad():
            logits, _ = model.forward(got.params, tb(batch), got.hook())
        want, _ = jmodel.forward(jart.params, jb(batch), jart.hook(), remat="none")
        close(logits.numpy(), want)
    else:
        tart.save(str(tmp_path))
        got = JArtifact.load(str(tmp_path), verify=True)
        jart.save(str(tmp_path / "j"))
        assert got.manifest["family"] == "audio"
        want = JArtifact.load(str(tmp_path / "j")).manifest
        assert got.manifest["checksums"] == want["checksums"]


# ---------------------------------------------------------------------------
# calibration across the boundary
# ---------------------------------------------------------------------------

KW = dict(w_bits=2, iters=6, calib_bs=8, stream_dtype="float32", use_fisher=True)


def calib_pair(cfg, jmodel, model, p):
    """2 batches of 4 x 16 tokens with their frames (N = 8 = calib_bs)."""
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1,
                         extras_fn=j_arch_extras_fn(cfg))
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1,
                       extras_fn=arch_extras_fn(cfg))
    for j, t in zip(jcal, cal):
        np.testing.assert_array_equal(t["frames"].numpy(), np.asarray(j["frames"]))
    return jcal, cal


@pytest.fixture(scope="module")
def runs(pair):
    cfg, jmodel, model, p = pair
    jp, tp = both(p)
    jcal, cal = calib_pair(cfg, jmodel, model, p)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = quantize(model, tp, cal, ReconConfig(**KW))
    finally:
        torch.set_num_threads(n)
    jres = jquantize(jmodel, jp, jcal, JReconConfig(**KW))
    return cfg, jmodel, model, jp, tp, jcal, cal, res, jres


@pytest.mark.parametrize("granularity", ["block", "stage", "net"])
def test_units_never_cross_the_boundary(pair, granularity):
    _, jmodel, model, _ = pair
    rc, jrc = ReconConfig(granularity=granularity), JReconConfig(granularity=granularity)
    walker = reconstruction.Walker(model)
    units = reconstruction._partition(walker, rc)
    assert units == j_partition(JWalker(jmodel), jrc)
    assert walker.encdec and walker.enc_n == 2
    assert [walker.block_path(i) for i in range(4)] == ["enc.0", "enc.1", "dec.0", "dec.1"]
    assert all(max(u) < 2 or min(u) >= 2 for u in units)


def test_brecq_matches_jax(runs):
    cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    assert res.stats["n_units"] == jres.stats["n_units"] == 4
    assert [u["unit"] for u in res.stats["units"]] == [[0], [1], [2], [3]]
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["unit"] == list(ju["unit"]) and tu["retries"] == ju["retries"] == 0
        for k in ("final_recon_mse", "rtn_recon_mse"):
            np.testing.assert_allclose(tu[k], float(ju[k]), rtol=1e-4)
    assert set(res.v) == set(jres.v) and set(res.qstates) == set(jres.qstates)
    assert any(p.startswith("enc.") for p in res.v) and any(p.startswith("dec.") for p in res.v)
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
    cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    export(model, res).save(str(tmp_path))
    got = JArtifact.load(str(tmp_path))  # schema, crc32, digest
    want = jexport(jmodel, jres)
    assert got.manifest["bits_by_path"] == want.manifest["bits_by_path"]
    assert got.manifest["family"] == want.manifest["family"] == "audio"
    batch = np_batch(cfg, 2, 8)
    logits, _ = jmodel.forward(got.params, jb(batch), got.hook(), remat="none")
    ref, _ = jmodel.forward(want.params, jb(batch), want.hook(), remat="none")
    close(logits, ref)


@pytest.mark.parametrize("bi", [1, 2])
def test_fisher_at_the_boundary_matches_jax(runs, bi):
    """The last encoder block's g^2 (its gradient crosses the boundary) and
    the first decoder block's."""
    cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    jf = JFisherStream(JWalker(jmodel), jp, jcal, mode="stream", dtype=jnp.float32)
    tf = FisherStream(reconstruction.Walker(model), tp, cal, mode="stream",
                      dtype=torch.float32)
    want = np.asarray(jf.for_block(bi))
    got = tf.for_block(bi).numpy()
    assert got.shape == want.shape == (8, 16, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
    assert float(np.abs(got).max()) > 0


def test_measure_crosses_the_boundary_like_jax(runs):
    from repro.core.sensitivity import measure as jmeasure
    from repro_torch.core import PTQResult
    from repro_torch.core.quantizer import QConfig, QState
    from repro_torch.core.sensitivity import measure

    cfg, jmodel, model, jp, tp, jcal, cal, res, jres = runs
    # two weights a block (its first and last), so each block takes three
    # probes: JAX's probes run eagerly
    keep = {p for bi in range(4) for p in
            [q for q in jres.qstates if q.startswith(f"{'enc' if bi < 2 else 'dec'}"
                                                      f".{bi % 2}/")][::5]}
    jsub = dataclasses.replace(jres, qstates={p: jres.qstates[p] for p in keep},
                               v={p: jres.v[p] for p in keep})
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    carried = PTQResult(
        params_q=None, act_scales={}, stats={},
        qstates={p: (QState(t(st.scale), t(st.zero_point)),
                     QConfig(**dataclasses.asdict(qc)))
                 for p, (st, qc) in jsub.qstates.items()},
        v={p: t(v) for p, v in jsub.v.items()})
    want = jmeasure(jmodel, jp, jcal, {2: jsub}, bits_options=(2,), n_samples=4)
    got = measure(model, tp, cal, {2: carried}, bits_options=(2,), n_samples=4)
    assert got.block_of == want.block_of and list(got.diag) == list(want.diag)
    assert sorted(set(got.block_of.values())) == [0, 1, 2, 3]
    assert list(got.offdiag) == list(want.offdiag)
    for k, v in want.diag.items():
        np.testing.assert_allclose(got.diag[k], v, rtol=1e-4)
    for k, v in want.offdiag.items():
        p1, p2 = k
        scale = abs(want.diag[(p1, 2)]) + abs(want.diag[(p2, 2)]) + abs(v)
        assert abs(got.offdiag[k] - v) <= 1e-4 * scale
