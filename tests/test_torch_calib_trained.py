"""The port's BRECQ calibration against the JAX package on the JAX-trained
reduced brecq-lm-100m (``tests/conftest.py::tiny_trained``), on the CPU.

Whole ``quantize`` runs, whose minibatches ``jax.random`` draws and torch
cannot replay, with ``calib_bs == N``, so that every minibatch is a
permutation of the calibration set and the unit loss, a mean, does not
depend on it: loss traces within rtol 1e-3, hardened ``v >= 0`` on at least
99.9% of weights alike, perplexity within 0.5%; and the quality ordering at
the JAX package's own settings. (The rest of the calibration's parity is in
``test_torch_calib.py``, MoE calibration in ``test_torch_calib_moe.py``.)
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import ReconConfig as JReconConfig
from repro.core import quantize as jquantize
from repro.core.evaluate import evaluate as jevaluate
from repro_torch.core import ReconConfig, quantize, reconstruction
from repro_torch.core.evaluate import evaluate
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from torch_threads import one_torch_thread  # noqa: F401


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained(tiny_trained):
    """The JAX-trained reduced model (tests/conftest.py) in both packages."""
    cfg, jmodel, jparams, jcal, jeval, _ = tiny_trained
    _, model = get_model("brecq_lm_100m", reduced=True)
    conv = lambda bs: [{"tokens": torch.tensor(np.asarray(b["tokens"]), dtype=torch.int64)}
                       for b in bs]  # noqa: E731
    tparams = params_from_numpy(np_tree(jparams), device="cpu")
    return jmodel, jparams, jcal, jeval, model, tparams, conv(jcal), conv(jeval)


# ---------------------------------------------------------------------------
# whole runs on the trained model
# ---------------------------------------------------------------------------


def test_quantize_trajectories_match_jax(trained):
    jmodel, jparams, jcal, jeval, model, params, cal, evalb = trained
    n = sum(b["tokens"].shape[0] for b in cal)
    kw = dict(w_bits=2, iters=10, calib_bs=n, stream_dtype="float32",
              input_source="quant", use_fisher=True)
    jres = jquantize(jmodel, jparams, jcal, JReconConfig(**kw))
    res = quantize(model, params, cal, ReconConfig(**kw))
    assert res.stats["n_units"] == jres.stats["n_units"] == 4
    for tu, ju in zip(res.stats["units"], jres.stats["units"]):
        assert tu["retries"] == ju["retries"] == 0
        np.testing.assert_allclose(tu["loss_trace"], np.asarray(ju["loss_trace"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tu["rtn_recon_mse"], ju["rtn_recon_mse"], rtol=1e-3)
    assert set(res.v) == set(jres.v)
    same = sum(int(((res.v[p] >= 0).numpy() == (np.asarray(jres.v[p]) >= 0)).sum())
               for p in res.v)
    total = sum(v.numel() for v in res.v.values())
    assert same / total >= 0.999, same / total
    jppl = jevaluate(jmodel, jres.params_q, jeval)["ppl"]
    tppl = evaluate(model, res.params_q, evalb)["ppl"]
    assert abs(tppl - jppl) <= 0.005 * jppl, (tppl, jppl)


def test_quality_ordering_at_jax_settings(trained):
    """FP < BRECQ-W2 < RTN-W2, and W4 within 0.05 of FP, at the JAX
    package's own settings (tests/test_reconstruction.py, which holds
    BRECQ-W2 <= RTN-W2 + 1e-3). On this 4-layer model the W2 gap is small
    (about 0.01 nats; the gap widens with depth and iterations)."""
    jmodel, jparams, jcal, jeval, model, params, cal, evalb = trained
    fp = evaluate(model, params, evalb)["loss"]
    w4 = quantize(model, params, cal, ReconConfig(w_bits=4, iters=60, calib_bs=8))
    assert evaluate(model, w4.params_q, evalb)["loss"] <= fp + 0.05
    res = quantize(model, params, cal, ReconConfig(w_bits=2, iters=120, calib_bs=8))
    brecq = evaluate(model, res.params_q, evalb)["loss"]
    qs = {p: s for p, s in res.qstates.items() if p != "embed/table"}
    rtn_params = reconstruction.bake(model, params, qs, {},
                                     {"embed/table": res.qstates["embed/table"]})
    rtn = evaluate(model, rtn_params, evalb)["loss"]
    assert fp < brecq < rtn, (fp, brecq, rtn)
