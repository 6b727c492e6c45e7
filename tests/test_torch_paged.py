"""Port parity: the paged KV cache of the serve engine
(repro_torch.models.common) vs the JAX package's ``repro.models.common``
on the same numpy inputs, for int8, float16, bfloat16 and float32 pools.

Pools are compared bit for bit outside page 0, the write sink: inactive
and padded writes all land there, and which of several writes to one
sink row wins is left undefined (the rows are never read). The JAX side
runs jitted, as in its engine, so int8 scales come from the same
``amax * f32(1/127)``. Attention agrees within 1e-4 (f32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro_torch.models import common as cm

TOL = 1e-4
PAGES, PS, KH, HD, H = 12, 4, 2, 16, 4
# 3 streams over a 4-page table: stream 2 holds only 2 pages, and row 1
# of the table has an unallocated hole
BT = np.array([[3, 7, 1, 9], [2, -1, 5, -1], [4, 11, -1, -1]], np.int32)


def _bits(a) -> np.ndarray:
    """Raw bits of a numpy array or tensor (bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype in (torch.float16, torch.bfloat16) else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _appends(rng):
    """A chunk of 6 tokens per stream (stream 1's from position 2), then
    two single-token steps."""
    steps = []
    for C, start in ((6, np.array([0, 2, 0])), (1, np.array([6, 8, 6])),
                     (1, np.array([7, 9, 7]))):
        pos = (start[:, None] + np.arange(C)[None]).astype(np.int32)
        k = rng.standard_normal((3, C, KH, HD)).astype(np.float32)
        v = rng.standard_normal((3, C, KH, HD)).astype(np.float32)
        steps.append((k, v, pos))
    return steps


@functools.lru_cache(maxsize=None)
def _j_append():
    return jax.jit(jcm.paged_append, static_argnums=(5,))


@pytest.fixture(scope="module", params=["int8", "float16", "bfloat16", "float32"])
def pools(request):
    """Both packages' pools after the same appends."""
    kv_dtype = request.param
    jc = jcm.init_paged_kv(PAGES, PS, KH, HD, kv_dtype)
    tc = cm.init_paged_kv(PAGES, PS, KH, HD, kv_dtype)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
    for k, v, pos in _appends(np.random.default_rng(0)):
        jc = _j_append()(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(BT),
                         jnp.asarray(pos), PS)
        out = cm.paged_append(tc, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(BT), torch.from_numpy(pos), PS)
        assert out is tc  # written in place
    return kv_dtype, jc, tc


def test_pools_equal_outside_sink(pools):
    kv_dtype, jc, tc = pools
    for name in jc:
        np.testing.assert_array_equal(_bits(tc[name][1:]), _bits(jc[name][1:]),
                                      err_msg=f"{kv_dtype} {name}")
    if kv_dtype == "int8":
        assert tc["k_scale"].dtype == torch.float16


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("window", [None, 3])
def test_paged_attend_matches_jax(pools, C, window):
    kv_dtype, jc, tc = pools
    rng = np.random.default_rng(C)
    q = rng.standard_normal((3, C, H, HD)).astype(np.float32)
    pos = (np.array([7, 9, 7])[:, None] - (C - 1) + np.arange(C)[None]).astype(np.int32)
    want = np.asarray(jcm.paged_attend(jnp.asarray(q), jc, jnp.asarray(BT),
                                       jnp.asarray(pos), PS, window=window,
                                       backend="xla"))
    got = cm.paged_attend(torch.from_numpy(q), tc, torch.from_numpy(BT),
                          torch.from_numpy(pos), PS, window=window,
                          backend="torch").numpy()
    assert got.shape == (3, C, H, HD)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_paged_view_matches_jax(pools):
    _, jc, tc = pools
    jg, jkpos = jcm.paged_view(jc, jnp.asarray(BT), PS)
    tg, tkpos = cm.paged_view(tc, torch.from_numpy(BT), PS)
    np.testing.assert_array_equal(tkpos.numpy(), np.asarray(jkpos))
    assert tkpos.dtype == torch.int32
    real = np.asarray(jkpos) >= 0  # rows of allocated pages
    for name in jc:
        np.testing.assert_array_equal(_bits(tg(tc[name]))[real],
                                      _bits(jg(jc[name]))[real])


def test_page_rows_route_to_sink():
    bt = np.array([[3, -1, 5], [-1, -1, -1]], np.int32)
    pos = np.array([[0, 5, 9, 12, 13], [0, 1, 2, 3, 4]], np.int32)  # 12, 13: past the table
    want = np.asarray(jcm._page_rows(jnp.asarray(bt), jnp.asarray(pos), PS))
    got = cm._page_rows(torch.from_numpy(bt), torch.from_numpy(pos), PS).numpy()
    np.testing.assert_array_equal(got, want)
    # unallocated entries (-1) and positions past the table land on page 0
    assert (got[0, [1, 3, 4]] < PS).all() and (got[1] < PS).all()
    np.testing.assert_array_equal(got[0, [0, 2]], [3 * PS, 5 * PS + 1])


def test_is_paged_and_bad_dtype():
    assert cm.is_paged(cm.init_paged_kv(2, PS, KH, HD, "float32"))
    assert not cm.is_paged({"k": torch.zeros(1), "v": torch.zeros(1)})
    assert cm.PAGED_KV_DTYPES == jcm.PAGED_KV_DTYPES
    with pytest.raises(ValueError, match="kv_dtype"):
        cm.init_paged_kv(2, PS, KH, HD, "int4")
