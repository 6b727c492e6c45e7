"""Multi-rank checks of the port's distribution plane on 4 gloo CPU ranks.

The ranks run in spawned processes (``repro_torch.dist.spawn.run_ranks``),
never in the pytest worker; each fixture is one spawn whose results the
tests below split:

* ``_compress_psum`` over the first n = 2, 3, 4 ranks, through 5 rounds of
  error feedback, against JAX's under ``jax.jit(jax.vmap(...,
  axis_name="data"))`` on the same numpy draws: g_hat and the error buffer
  bit for bit (so the codes too).
* ``make_dp_train_step`` on 4 ranks (reduced brecq, 4 steps): the int8
  all-reduce equal to its arithmetic on all ranks' gradients, the loss
  falling, the error buffer non-zero, the curve within 0.05 of the
  uncompressed f32 run's (JAX's ``test_grad_compress_int8_matches_uncompressed``).
* ``make_train_step`` under dp, tp, fsdp and zero3 on the (2, 2) data x
  model mesh against the same step on whole tensors (reduced brecq; the
  MoE layers run sharded in the serves and in the dry run): bf16 compute,
  so the loss within
  1e-3 relative, the gradient norm within 3e-3, every param within 2 * lr
  (Adam's first step is lr * sign(g), so this bound holds for any
  gradient), and each leaf's gradient, read from Adam's first moment
  ((1 - b1) g after one step),
  within 5e-2 of the one-rank step's in norm (bf16 noise: 3.6e-3 under
  dp, 1.9e-2 under zero3, 1.5e-2 between the one-rank step and JAX's; a
  gradient on the wrong columns reads 1.4); params and Adam state per rank: a
  quarter (fsdp, zero3) or a half (tp) of dp's, within the replicated
  norms.
* Packed W4 ``make_prefill_step`` + ``make_decode_step`` under
  ``Plan("tp")`` on (2, 2), qmm's plain backend (CPU tensors), reduced
  tinyllama and reduced deepseek-moe: the greedy tokens equal the one-rank
  serve's and the logits within the kernels' limit (1e-4 * max|logit| +
  1e-5); codes per rank half the whole (N over the model axis of 2).
"""
from functools import partial

import jax
import numpy as np
import pytest

from repro.optim.grad_compress import _compress_psum as j_compress_psum
from repro_torch.dist import checks
from repro_torch.dist.spawn import run_ranks

WORLD = 4
SIZES = (2, 3, 4)
ROUNDS, SHAPE, SEED = 5, (64, 33), 7
MESH = (2, 2)


@pytest.fixture(scope="module")
def ranks():
    """One spawn: the compressed all-reduce's rounds, the int8 DP step and
    the packed TP serves."""
    calls = [("compress_rounds", (SIZES, ROUNDS, SHAPE, SEED)),
             ("dp_int8", ("brecq_lm_100m", True, "cpu", 8, 32, 4)),
             ("serve", ("tinyllama_1_1b", True, "cpu", MESH, 4, 4, 16, 4)),
             ("serve", ("deepseek_moe_16b", True, "cpu", MESH, 4, 4, 16, 4))]
    return run_ranks(checks.several, WORLD, calls, timeout=600)


@pytest.mark.parametrize("n", SIZES)
def test_compress_psum_matches_jax_bit_for_bit(ranks, n):
    f = jax.jit(jax.vmap(partial(j_compress_psum, axis="data"), axis_name="data"))
    rng = np.random.default_rng(SEED + n)
    e = np.zeros((n, *SHAPE), np.float32)
    for i in range(ROUNDS):
        g = rng.standard_normal((n, *SHAPE)).astype(np.float32)
        g *= (10.0 ** rng.uniform(-3, 1, (n,) + (1,) * len(SHAPE))).astype(np.float32)
        g_hat, e = map(np.asarray, f(g, e))
        for r in range(n):
            got_hat, got_e = ranks[r][0][n][i]
            np.testing.assert_array_equal(got_hat, g_hat[r])
            np.testing.assert_array_equal(got_e, e[r])


def test_int8_dp_step_trains_beside_uncompressed(ranks):
    for rank in ranks:
        r = rank[1]
        assert r["unequal"] == 0 and r["max_abs_diff"] == 0.0, r
    r = ranks[0][1]
    assert r["int8_losses"][-1] < r["int8_losses"][0], r["int8_losses"]
    assert r["err_abs_sum"] > 0
    gap = max(abs(a - b) for a, b in zip(r["int8_losses"], r["f32_losses"]))
    assert gap < 0.05, (r["int8_losses"], r["f32_losses"])


@pytest.mark.parametrize("which", [2, 3], ids=["tinyllama", "deepseek_moe"])
def test_packed_tp_serve_matches_one_rank(ranks, which):
    for rank in ranks:
        r = rank[which]
        assert r["tokens_equal"], r
        assert r["max_abs_diff"] <= 1e-4 * r["max_abs_logit"] + 1e-5, r
        assert 2 * r["codes_bytes_rank"] == r["codes_bytes_whole"], r


@pytest.fixture(scope="module")
def train():
    return run_ranks(checks.train_steps, WORLD, "brecq_lm_100m", True, "cpu", MESH,
                     ("dp", "tp", "fsdp", "zero3"), 4, 32, timeout=600)


@pytest.mark.parametrize("strategy", ["dp", "tp", "fsdp", "zero3"])
def test_sharded_train_step_matches_one_rank(train, strategy):
    r = train[0][strategy]
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-3)
    np.testing.assert_allclose(r["gnorm"], r["ref_gnorm"], rtol=3e-3)
    assert r["max_param_diff"] <= 2 * r["lr"] * (1 + 1e-3) + 1e-7, r
    assert r["m_rel"] <= 5e-2, r
    dp = train[0]["dp"]
    share = {"dp": 1.0, "tp": 0.5, "fsdp": 0.25, "zero3": 0.25}[strategy]
    whole = dp["param_bytes"] + dp["adam_bytes"]
    assert r["param_bytes"] + r["adam_bytes"] <= share * whole * 1.05, r
