"""The port's mixed-precision search (``core/sensitivity.py``,
``core/mixed_precision.py``) against the JAX package, on the CPU.

``measure`` runs on a 2-layer cut of reduced brecq-lm-100m, given the
same calibrated results in both packages (the JAX ``quantize`` results,
carried across), so only ``measure`` differs: the diagonal and the joint
pair errors within rtol 1e-4 (the off-diagonal term is a difference of
those, compared at the scale of the errors it comes from). The GA, its
Pareto sweep, ``fitness`` and the cost model are pure numpy: equal
exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ReconConfig as JReconConfig
from repro.core import mixed_precision as jmp
from repro.core import quantize as jquantize
from repro.core.sensitivity import SensTable as JSensTable
from repro.core.sensitivity import measure as jmeasure
from repro.data import Corpus as JCorpus
from repro.data import CorpusConfig as JCorpusConfig
from repro.data import make_batches as jmake_batches
from repro.deploy.budget import bytes_cost_table as jbytes_cost_table
from repro.models import build_model as j_build_model
from repro.models import get_config as j_get_config
from repro_torch.core import PTQResult
from repro_torch.core import mixed_precision as tmp
from repro_torch.core.quantizer import QConfig, QState
from repro_torch.core.sensitivity import SensTable, measure
from repro_torch.data import Corpus, CorpusConfig, make_batches
from repro_torch.deploy.budget import bytes_cost_table
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model

BITS = (2, 4)


@pytest.fixture(scope="module")
def tables():
    """JAX W2 and W4 calibrations of a 2-layer reduced brecq-lm-100m, and
    the sensitivity table each package measures from them."""
    cfg = dataclasses.replace(j_get_config("brecq_lm_100m", reduced=True), n_layers=2)
    jmodel, model = j_build_model(cfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jcal = jmake_batches(JCorpus(JCorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1)
    cal = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 4, 32, seed=1)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jres = {b: jquantize(jmodel, jparams, jcal, JReconConfig(w_bits=b, iters=4, calib_bs=4))
            for b in BITS}

    def carried(r):
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        return PTQResult(
            params_q=None, act_scales={}, stats={},
            qstates={p: (QState(t(st.scale), t(st.zero_point)),
                         QConfig(**dataclasses.asdict(qc)))
                     for p, (st, qc) in r.qstates.items()},
            v={p: t(v) for p, v in r.v.items()})

    want = jmeasure(jmodel, jparams, jcal, jres, bits_options=BITS, n_samples=4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = measure(model, params, cal, {b: carried(r) for b, r in jres.items()},
                      bits_options=BITS, n_samples=4)
    finally:
        torch.set_num_threads(n)
    return want, got


def test_measure_matches_jax(tables):
    want, got = tables
    assert got.shapes == want.shapes and got.block_of == want.block_of
    assert list(got.diag) == list(want.diag) and list(got.offdiag) == list(want.offdiag)
    assert len(got.shapes) == 14 and len(got.offdiag) == 2 * 21
    for k, v in want.diag.items():
        assert np.isfinite(got.diag[k])
        np.testing.assert_allclose(got.diag[k], v, rtol=1e-4)
    for (p1, p2), v in want.offdiag.items():
        joint = v + want.diag[(p1, 2)] + want.diag[(p2, 2)]
        got_joint = got.offdiag[(p1, p2)] + got.diag[(p1, 2)] + got.diag[(p2, 2)]
        np.testing.assert_allclose(got_joint, joint, rtol=1e-4)
        scale = abs(want.diag[(p1, 2)]) + abs(want.diag[(p2, 2)]) + abs(joint)
        assert abs(got.offdiag[(p1, p2)] - v) <= 1e-4 * scale
    # 2-bit hurts more than 4-bit for every layer
    assert all(got.diag[(p, 2)] >= got.diag[(p, 4)] for p in got.shapes)


def test_senstable_json_loads_in_both_packages(tables, tmp_path):
    want, got = tables
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    assert JSensTable.load(str(tmp_path / "port.json")).to_json() == got.to_json()
    back = SensTable.load(str(tmp_path / "jax.json"))
    assert back.to_json() == want.to_json()
    assert back == SensTable.from_json(want.to_json())


def both(table):
    """The same table in both packages (through the shared JSON)."""
    doc = table.to_json()
    return JSensTable.from_json(doc), SensTable.from_json(doc)


@pytest.mark.parametrize("seed", range(4))
def test_fitness_matches_jax(tables, seed):
    jsens, sens = both(tables[0])
    rng = np.random.default_rng(seed)
    for _ in range(20):
        assign = {p: int(rng.choice(tmp.BIT_CHOICES)) for p in sens.shapes}
        assert tmp.fitness(sens, assign) == jmp.fitness(jsens, assign)
    assert tmp.model_bytes(sens.shapes, assign) == jmp.model_bytes(jsens.shapes, assign)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("constraint", ["bytes_fn", "cost_table"])
def test_genetic_search_matches_jax(tables, seed, constraint):
    jsens, sens = both(tables[0])
    lo = tmp.model_bytes(sens.shapes, {p: 2 for p in sens.shapes})
    hi = tmp.model_bytes(sens.shapes, {p: 8 for p in sens.shapes})
    delta = lo + (0.2 + 0.3 * seed) * (hi - lo)
    if constraint == "bytes_fn":
        tcost = lambda a: tmp.model_bytes(sens.shapes, a)  # noqa: E731
        jcost = lambda a: jmp.model_bytes(jsens.shapes, a)  # noqa: E731
    else:
        tcost, jcost = bytes_cost_table(sens.shapes), jbytes_cost_table(jsens.shapes)
    ga = dict(pop_size=16, iters=12, seed=seed)
    assign, info = tmp.genetic_search(sens, tcost, delta, tmp.GAConfig(**ga))
    jassign, jinfo = jmp.genetic_search(jsens, jcost, delta, jmp.GAConfig(**ga))
    assert assign == jassign
    assert info == jinfo
    assert info["cost"] <= delta
    assert all(info["history"][i + 1] <= info["history"][i]
               for i in range(len(info["history"]) - 1))


def test_pareto_sweep_matches_jax(tables):
    jsens, sens = both(tables[0])
    lo = tmp.model_bytes(sens.shapes, {p: 2 for p in sens.shapes})
    hi = tmp.model_bytes(sens.shapes, {p: 8 for p in sens.shapes})
    deltas = [lo + f * (hi - lo) for f in (0.1, 0.5, 0.9)]
    ga = dict(pop_size=10, iters=6, seed=1)
    got = tmp.pareto_sweep(sens, bytes_cost_table(sens.shapes), deltas, tmp.GAConfig(**ga))
    want = jmp.pareto_sweep(jsens, jbytes_cost_table(jsens.shapes), deltas,
                            jmp.GAConfig(**ga))
    assert got == want
    assert all(r["cost"] <= r["delta"] for r in got)
    with pytest.raises(ValueError, match="infeasible"):
        tmp.genetic_search(sens, bytes_cost_table(sens.shapes), lo / 2)


def test_h100_cost_model_matches_tpu_cost_model():
    h100 = tmp.H100CostModel()
    assert (h100.peak_flops_bf16, h100.hbm_bw) == (989e12, 3.35e12)
    jm = jmp.TPUCostModel(peak_flops_bf16=989e12, hbm_bw=3.35e12)
    shapes = {"body.0/a": (768, 768), "body.0/b": (768, 2048),
              "moe.0/e": (64, 2048, 1408), "moe.1/e": (64, 1408, 2048)}
    for tokens in (1, 8, 1024, 65536):
        t, j = (dataclasses.replace(h100, tokens_per_step=tokens),
                dataclasses.replace(jm, tokens_per_step=tokens))
        for shape in shapes.values():
            for b in tmp.BIT_CHOICES:
                for a in (8, 16):
                    assert t.layer_latency_s(shape, b, a) == j.layer_latency_s(shape, b, a)
        bits = {p: 4 for p in shapes}
        assert t.model_latency_s(shapes, bits) == j.model_latency_s(shapes, bits)
    fn = lambda p, s, b: 1e-6 * b * len(p)  # noqa: E731
    bits = dict(zip(shapes, (2, 4, 8, 2)))
    assert (tmp.H100CostModel(layer_cost_fn=fn).model_latency_s(shapes, bits)
            == jmp.TPUCostModel(layer_cost_fn=fn).model_latency_s(shapes, bits))
