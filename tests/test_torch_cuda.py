"""The CUDA qmatmul kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here is marked
``requires_cuda`` and skips without a GPU. This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: 1e-4 * max|ref| + 1e-5 (f32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantizer import pack_int
from repro_torch.kernels.qmatmul import kernel, ops, ref

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def case(bits, k, n, g, m, device, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    wp = pack_int(torch.from_numpy(codes), bits)
    s = rng.uniform(0.005, 0.02, size=(g, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return (torch.from_numpy(x).to(device), wp.to(device),
            torch.from_numpy(s).to(device))


def check(got, want):
    torch.cuda.synchronize()
    tol = 1e-4 * float(want.abs().max()) + 1e-5
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


# (k, n, g): the brecq-lm-100m serving shapes, ragged N, odd N (no 32-bit
# loads), K not a multiple of the 32-row k-step, groups smaller than it
SHAPES = [(768, 768, 1), (768, 2048, 6), (2048, 768, 16), (768, 200, 1),
          (256, 77, 2), (96, 64, 3), (64, 40, 8)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", SHAPES)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_qgemv_kernel_matches_plain(cuda, bits, k, n, g, m):
    x, wp, s = case(bits, k, n, g, m, cuda)
    before = kernel.LAUNCHES["qgemv"]
    got = kernel.qgemv(x, wp, s, bits=bits)
    assert kernel.LAUNCHES["qgemv"] == before + 1
    check(got, ref.qgemv_ref(x, wp, s, bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", SHAPES)
@pytest.mark.parametrize("m", [9, 512, 520])
def test_qmatmul_kernel_matches_plain(cuda, bits, k, n, g, m):
    x, wp, s = case(bits, k, n, g, m, cuda)
    before = kernel.LAUNCHES["qmatmul"]
    got = kernel.qmatmul(x, wp, s, bits=bits)
    assert kernel.LAUNCHES["qmatmul"] == before + 1
    check(got, ref.qmatmul_ref(x, wp, s, bits))


def test_int8_odd_k(cuda):
    """8-bit codes allow any K: K=100 has a partial last k-step."""
    x, wp, s = case(8, 100, 48, 1, 8, cuda)
    check(kernel.qgemv(x, wp, s, bits=8), ref.qgemv_ref(x, wp, s, 8))
    x2 = torch.cat([x] * 70)
    check(kernel.qmatmul(x2, wp, s, bits=8), ref.qmatmul_ref(x2, wp, s, 8))


def test_misaligned_activation_view(cuda):
    """A view whose base is not 16-byte aligned is read correctly."""
    x, wp, s = case(4, 256, 64, 1, 9, cuda)
    view = x.reshape(-1)[1:1 + 8 * 256].reshape(8, 256)  # base 4 bytes in
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    check(kernel.qgemv(view, wp, s, bits=4), ref.qgemv_ref(view, wp, s, 4))


def test_qmm_auto_dispatch_launches_kernels(cuda):
    x, wp, s = case(4, 256, 128, 1, 8, cuda)
    qw = ops.QuantizedLinear(wp, s, 4, 256)
    kernel.reset_launches()
    check(ops.qmm(x, qw), ref.qgemv_ref(x, wp, s, 4))
    xb = torch.cat([x] * 8)
    check(ops.qmm(xb, qw), ref.qmatmul_ref(xb, wp, s, 4))
    assert kernel.LAUNCHES == {"qgemv": 1, "qmatmul": 1}
    # the plain backend launches nothing
    ops.qmm(x, qw, backend="torch")
    assert kernel.LAUNCHES == {"qgemv": 1, "qmatmul": 1}


def test_wrappers_reject_bad_operands(cuda):
    x, wp, s = case(4, 256, 64, 1, 8, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.qgemv(x.cpu(), wp, s, bits=4)
    with pytest.raises(TypeError, match="float32"):
        kernel.qgemv(x.double(), wp, s, bits=4)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.qmatmul(torch.cat([x] * 2, 1)[:, ::2], wp, s, bits=4)
