"""Port parity: the serve engine's int8 decode read through the paged entry
(``kernels.kvattn.ops.attend_int8_paged``) vs the JAX package's
``repro.models.common.paged_attend`` on the same numpy pools.

On the card the paged entry reads the pool through the block tables in the
kernel; its plain version (``backend='torch'``, what the CPU runs) gathers
the dense view as ``kernels.kvattn.ref.paged_view`` does (codes, float16 scales
widened to f32, kpos = t where the slot's page is allocated, -1 elsewhere)
and runs ``kv_decode_ref``. Both are held against JAX within 1e-4 (f32 sums
in another order) over pools with idle rows (all -1 tables), partly
allocated pages and holes, a window, and head dim 120. ``paged_attend``
sends single-token int8 reads there before any gather, and keeps the
gathered view for chunked-prefill reads and float pools.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro_torch.kernels.kvattn import ops
from repro_torch.models import common as cm
from torch_threads import one_torch_thread  # noqa: F401


TOL = 1e-4


def _pool(rng, pages, ps, K, hd, B, mp, *, idle=0, holes=False):
    """A random int8 pool (codes, float16 scales), block tables that give
    stream b pages for positions 0..cur_b (shuffled, -1 beyond; ``holes``:
    some earlier pages -1 too; the first ``idle`` rows all -1), cur."""
    codes = lambda: rng.integers(-128, 128, size=(pages, ps, K, hd)).astype(np.int8)  # noqa: E731
    scale = lambda: rng.uniform(0.005, 0.05, size=(pages, ps, K)).astype(np.float16)  # noqa: E731
    pool = {"k_pages": codes(), "v_pages": codes(), "k_scale": scale(), "v_scale": scale()}
    S = mp * ps
    cur = rng.integers(S // 4, S, size=(B,)).astype(np.int32)
    bt = (1 + rng.permutation(pages - 1)[:B * mp]).reshape(B, mp).astype(np.int32)
    bt[np.arange(mp)[None] > (cur // ps)[:, None]] = -1
    if holes:
        bt[rng.random((B, mp)) < 0.3] = -1
    bt[:idle] = -1
    return pool, bt, cur


# (B, H, K, hd, page_size, max_pages, idle rows, holes, window): the engine's
# decode shape at reduced size, GQA with holes, a window, h2o-danube3-4b's
# head dim 120 (G 4), a page size that does not divide the kernel's tile
CASES = [(3, 4, 4, 16, 4, 6, 1, False, None), (4, 8, 2, 32, 4, 9, 0, True, None),
         (3, 4, 2, 64, 16, 4, 1, False, 20), (2, 8, 2, 120, 8, 5, 0, True, None),
         (3, 4, 1, 32, 5, 7, 2, True, 9)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-H{}-K{}-hd{}-ps{}-mp{}-idle{}-holes{}-w{}".format(*c))
def test_attend_int8_paged_matches_jax(case):
    B, H, K, hd, ps, mp, idle, holes, window = case
    rng = np.random.default_rng(hd + ps)
    pool, bt, cur = _pool(rng, 1 + B * mp, ps, K, hd, B, mp, idle=idle, holes=holes)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    want = np.asarray(jcm.paged_attend(
        jnp.asarray(q[:, None]), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(bt), jnp.asarray(cur[:, None]), ps, window=window, backend="xla"))[:, 0]
    tpool = {k: torch.from_numpy(v) for k, v in pool.items()}
    args = (torch.from_numpy(q), tpool, torch.from_numpy(bt), torch.from_numpy(cur), ps)
    got = ops.attend_int8_paged(*args, window=window, backend="torch")
    auto = ops.attend_int8_paged(*args, window=window)  # CPU tensors: the plain version
    assert got.shape == (B, H, hd) and torch.isfinite(got).all()
    np.testing.assert_array_equal(auto.numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if idle:  # an idle row reads page 0, all masked: the mean of V over S, as the gather
        v = pool["v_pages"][0].astype(np.float32) * pool["v_scale"][0].astype(np.float32)[..., None]
        mean = np.repeat(v.mean(0), H // K, axis=0)
        np.testing.assert_allclose(got[0].numpy(), mean, atol=TOL, rtol=TOL)


def test_attend_int8_paged_backends():
    rng = np.random.default_rng(0)
    pool, bt, cur = _pool(rng, 7, 4, 2, 16, 2, 3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    tpool = {k: torch.from_numpy(v) for k, v in pool.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attend_int8_paged(q, tpool, torch.from_numpy(bt), torch.from_numpy(cur), 4,
                              backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.attend_int8_paged(q, tpool, torch.from_numpy(bt), torch.from_numpy(cur), 4,
                              backend="pallas")


@pytest.mark.parametrize("C,kv_dtype,routed", [(1, "int8", True), (3, "int8", False),
                                                (1, "float32", False)])
def test_paged_attend_routes_single_token_int8_reads(monkeypatch, C, kv_dtype, routed):
    """paged_attend hands single-token reads of an int8 pool to
    attend_int8_paged (before any gather); chunked-prefill reads and float
    pools keep the gathered view."""
    rng = np.random.default_rng(1)
    cache = cm.init_paged_kv(7, 4, 2, 16, kv_dtype)
    bt = torch.tensor([[3, 1, 5], [2, -1, -1]], dtype=torch.int32)
    pos = torch.tensor([[9], [2]], dtype=torch.int32) + torch.arange(C, dtype=torch.int32) - (C - 1)
    cm.paged_append(cache, torch.from_numpy(rng.standard_normal((2, C, 2, 16)).astype(np.float32)),
                    torch.from_numpy(rng.standard_normal((2, C, 2, 16)).astype(np.float32)),
                    bt, pos, 4)
    calls = []
    orig = ops.attend_int8_paged

    def spy(*a, **kw):
        calls.append(kw["backend"])
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "attend_int8_paged", spy)
    q = torch.from_numpy(rng.standard_normal((2, C, 4, 16)).astype(np.float32))
    out = cm.paged_attend(q, cache, bt, pos, 4, backend="torch")
    assert out.shape == (2, C, 4, 16) and torch.isfinite(out).all()
    assert calls == (["torch"] if routed else [])
