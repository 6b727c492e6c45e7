import os

# Tests run on the single real CPU device. The 512-device override is
# exclusively for launch/dryrun.py (per assignment).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def tiny_trained():
    """A small trained LM shared by reconstruction/baseline/system tests."""
    import jax.numpy as jnp

    from repro.data import Corpus, CorpusConfig, make_batches
    from repro.models import get_model
    from repro.optim import adam

    cfg, model = get_model("brecq_lm_100m", reduced=True)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    params = model.init(jax.random.PRNGKey(0))
    acfg = adam.AdamConfig(lr=3e-3, grad_clip=1.0)
    state = adam.init(params)

    @jax.jit
    def step(params, state, batch):
        loss, g = jax.value_and_grad(
            lambda p: model.loss(p, batch, remat="none"))(params)
        return (*adam.update(acfg, g, state, params), loss)

    for i in range(200):
        batch = make_batches(corpus, 1, 16, 64, seed=0, start_step=i)[0]
        params, state, loss = step(params, state, batch)
    calib = make_batches(corpus, 6, 8, 64, seed=1, start_step=1000)
    evalb = make_batches(corpus, 3, 16, 64, seed=2, start_step=2000)
    return cfg, model, params, calib, evalb, float(loss)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA device (skips without one)")
