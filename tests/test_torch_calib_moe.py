"""MoE calibration in the port against the JAX package, on the CPU.

Multi-stack units and stacked (E, K, N) expert weights: reduced
deepseek-moe-16b and qwen3-moe, dense and capacity routing, one W2
``quantize`` per (config, routing) in both packages with ``calib_bs == N``
and f32 streams (so minibatches do not matter): loss traces within rtol
1e-3, hardened codes alike on 99.9% of weights, expert scales shared as in
JAX; the export loads in JAX, and per-layer bits promote each stack as
JAX's export does, digest for digest. (Split out of
``test_torch_calib.py``, whose module doc states the tolerances.)
"""
import dataclasses

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
from repro.deploy import QuantizedArtifact as JArtifact
from repro.models import get_model as j_get_model
from repro_torch.core import ReconConfig, quantize, reconstruction
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.deploy import QuantizedArtifact, export
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import get_model
from torch_threads import one_torch_thread  # noqa: F401


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# MoE calibration (multi-stack units, stacked (E, K, N) expert weights)
# ---------------------------------------------------------------------------

MOE_KW = dict(w_bits=2, iters=6, calib_bs=8, stream_dtype="float32", use_fisher=True)


def moe_pair(arch, impl):
    """Reduced MoE model in both packages, the same random weights, and 2
    calibration batches of 4 x 16 tokens (N = 8 = calib_bs)."""
    cfg, jmodel = j_get_model(arch, reduced=True, moe_impl=impl)
    _, model = get_model(arch, reduced=True, moe_impl=impl)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1)
    params = params_from_numpy(np_tree(jparams), device="cpu")
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 16, seed=1)
    return cfg, jmodel, jparams, jcal, model, params, cal


@pytest.fixture(scope="module", params=[
    ("deepseek_moe_16b", "dense"), ("deepseek_moe_16b", "capacity"),
    ("qwen3_moe_235b_a22b", "dense"), ("qwen3_moe_235b_a22b", "capacity")],
    ids=lambda p: "-".join(p))
def moe_runs(request):
    """One W2 ``quantize`` per (config, routing) in both packages,
    ``calib_bs == N`` and f32 streams (so minibatches do not matter)."""
    cfg, jmodel, jparams, jcal, model, params, cal = moe_pair(*request.param)
    jres = jquantize(jmodel, jparams, jcal, JReconConfig(**MOE_KW))
    res = quantize(model, params, cal, ReconConfig(**MOE_KW))
    return cfg, jmodel, model, res, jres


def test_moe_quantize_matches_jax(moe_runs):
    cfg, _, _, res, jres = moe_runs
    n_units = cfg.n_layers
    assert res.stats["n_units"] == jres.stats["n_units"] == n_units
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["retries"] == ju["retries"] == 0
        np.testing.assert_allclose(tu["loss_trace"], np.asarray(ju["loss_trace"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tu["rtn_recon_mse"], ju["rtn_recon_mse"], rtol=1e-3)
    assert set(res.v) == set(jres.v)
    experts = [p for p in res.v if res.v[p].ndim == 3]
    assert experts and all(p.startswith("moe.") for p in experts)
    same = sum(int(((res.v[p] >= 0).numpy() == (np.asarray(jres.v[p]) >= 0)).sum())
               for p in res.v)
    total = sum(v.numel() for v in res.v.values())
    assert same / total >= 0.999, same / total
    for p in experts:  # expert scales are shared across experts, as in JAX
        st, _ = res.qstates[p]
        assert st.scale.shape == (1, 1, res.v[p].shape[-1])
        np.testing.assert_allclose(st.scale.numpy(), np.asarray(jres.qstates[p][0].scale),
                                   rtol=1e-6)


def test_moe_export_loads_in_jax(moe_runs, tmp_path):
    from repro.deploy import export as jexport

    _, jmodel, model, res, jres = moe_runs
    art = export(model, res)
    art.save(str(tmp_path))
    jart = JArtifact.load(str(tmp_path))  # verifies schema, crc32, digest
    want = jexport(jmodel, jres)
    assert jart.manifest["bits_by_path"] == want.manifest["bits_by_path"]
    got_leaves = jax.tree_util.tree_flatten_with_path(jart.params)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want.params)[0]
    assert [(k, a.shape, a.dtype) for k, a in got_leaves] == \
        [(k, a.shape, a.dtype) for k, a in want_leaves]
    assert jart.nbytes() == want.nbytes()
    # the calibrated experts' scales are shared, (1, 1, N) a layer: the
    # packed forward equals JAX's forward on the baked weights, and so does
    # a decode step (<= 8 rows an expert, the decode tier). (JAX's own
    # packed path scans experts and scales together at <= 8 rows, and
    # rejects a scale shared by the experts.)
    tart = QuantizedArtifact.load(str(tmp_path))
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 8))
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        got = model.forward(tart.params, batch, tart.hook())[0]
        logits = []
        for params in (tart.params, res.params_q):
            cache = model.init_cache(2, 9, torch.float32, "cpu")
            _, cache = model.prefill(params, batch, cache, tart.hook())
            logits.append(model.decode_step(params, batch["tokens"][:, -1:], cache,
                                            torch.full((2,), 8, dtype=torch.int32),
                                            tart.hook())[0])
    ref = np.asarray(jmodel.forward(np_tree(params_to_numpy(res.params_q)),
                                    {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(), rtol=1e-4,
                               atol=1e-4 * float(logits[1].abs().max()))


def test_moe_per_layer_bits_export_matches_jax(tmp_path):
    """Mixed bits across a MoE model's layers: the port's export promotes
    each stack to its widest layer's container, and the JAX package's
    export of the same calibration gives the same artifact, digest
    included."""
    from repro.core.quantizer import QConfig as JQConfig
    from repro.core.quantizer import QState as JQState
    from repro.core.reconstruction import PTQResult as JPTQResult
    from repro.deploy import export as jexport

    cfg, jmodel, _, _, model, params, cal = moe_pair("deepseek_moe_16b", "dense")
    paths = [p for p in reconstruction.enumerate_weights(model, params, cal[0])
             if "." in p.split("/")[0]]
    rng = np.random.default_rng(3)
    bits = {p: int(rng.choice([2, 4, 8])) for p in paths}
    res = quantize(model, params, cal, ReconConfig(**{**MOE_KW, "per_layer_bits": bits}))
    assert {p: res.qstates[p][1].bits for p in paths} == bits
    art = export(model, res)
    art.save(str(tmp_path))
    jart = JArtifact.load(str(tmp_path))
    got = jart.manifest["bits_by_path"]
    assert {p: got[p] for p in paths} == bits
    assert {p: b for p, b in got.items() if p not in bits} == {"embed/table": 8, "head/w": 8}
    jres = JPTQResult(
        params_q=np_tree(params_to_numpy(res.params_q)), act_scales={},
        qstates={p: (JQState(jnp.asarray(st.scale.numpy()), jnp.asarray(st.zero_point.numpy())),
                     JQConfig(**dataclasses.asdict(qc)))
                 for p, (st, qc) in res.qstates.items()},
        v={p: jnp.asarray(v.numpy()) for p, v in res.v.items()}, stats={})
    want = jexport(jmodel, jres)
    want.save(str(tmp_path / "jax"))
    assert want.manifest["bits_by_path"] == jart.manifest["bits_by_path"]
    assert want.manifest["content_digest"] == jart.manifest["content_digest"]
    for key in ("moe", "dense0"):  # stacks promoted to their widest layer
        node = jart.params[key]["sub0"]["attn"]["wq"]
        widest = max(b for p, b in bits.items() if p.startswith(f"{key}.")
                     and p.endswith("/attn/wq"))
        assert node["w"].shape[-2] == cfg.d_model * widest // 8
