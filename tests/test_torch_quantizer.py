"""Port parity: sub-byte packing (repro_torch.core.quantizer) vs the JAX
package. Packed bytes and unpacked codes must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro_torch.core import quantizer as tq


def _codes(rng, shape, bits):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", [0, -2])
def test_pack_unpack_matches_jax(bits, axis):
    rng = np.random.default_rng(bits)
    q = _codes(rng, (64, 24), bits)
    want = np.asarray(jq.pack_int(jnp.asarray(q), bits, axis=axis))
    got = tq.pack_int(torch.from_numpy(q), bits, axis=axis)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)  # byte-identical
    back = tq.unpack_int(got, bits, 64, axis=axis)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.unpack_int(jnp.asarray(want), bits, 64, axis=axis)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_stacked_leaf_matches_jax(bits):
    """(L, K, N) stacked leaves pack along K (axis -2), per layer."""
    rng = np.random.default_rng(10 + bits)
    q = _codes(rng, (3, 32, 40), bits)
    want = np.asarray(jq.pack_int(jnp.asarray(q), bits, axis=-2))
    got = tq.pack_int(torch.from_numpy(q), bits, axis=-2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.unpack_int(got, bits, 32, axis=-2).numpy(), q)


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError, match="multiple of 4"):
        tq.pack_int(torch.zeros((6, 3), dtype=torch.int8), 2, axis=0)


def test_torch_round_is_half_to_even():
    """RTN codes rely on round-half-to-even, as jnp.round does."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    got = torch.round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [-2, -2, -0, 0, 2, 2, 4])
    np.testing.assert_array_equal(got, np.asarray(jnp.round(jnp.asarray(x))))
