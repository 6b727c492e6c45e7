"""The CUDA kernels (qgemv, qmatmul, qmatmul_grouped, kv_decode and its paged
entry, fakequant, on 2-D weights and on stacks of experts) against their
plain PyTorch versions, on the card, also at the recurrent families'
shapes (N 8, 16 and 32,001; K 1,600 and 3,200), and the serve engine's,
the MoE layer's, the calibration's, the budgeted deployment's (the
measured cost table, ``serve --budget-bytes``) and the recurrent
families' kernel paths.

The kernels have no CPU mode, so every test here is marked
``requires_cuda`` and skips without a GPU. This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: 1e-4 * max|ref| + 1e-5 (f32 sums taken in another order; the
tensor-core bodies' split of x, hi + lo in TF32 or three bf16 parts, adds
below 2^-21 relative per product); fakequant: hard bit for bit, soft
within 1e-6 * max|ref|; kv_decode's paged entry equals the dense entry on
the gathered view bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantizer import pack_int
from repro_torch.kernels import spec
from repro_torch.kernels.kvattn import kernel as kv_kernel
from repro_torch.kernels.kvattn import ops as kv_ops
from repro_torch.kernels.kvattn.ref import kv_decode_ref
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


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", SHAPES)
@pytest.mark.parametrize("m", [16, 17, 32, 33, 64, 65])
def test_qmatmul_tensor_core_tiles_match_plain(cuda, bits, k, n, g, m):
    """Both tensor-core tiles (short up to 32 rows, wide above) and their
    ragged M edges."""
    x, wp, s = case(bits, k, n, g, m, cuda)
    check(kernel.qmatmul(x, wp, s, bits=bits), ref.qmatmul_ref(x, wp, s, bits))


# (bits, group): groups of 8, 16 and 128 k take the tensor cores; groups
# that are not a whole number of k-units (8 k, 16 for W2) the CUDA cores
@pytest.mark.parametrize("bits,group", [(4, 8), (4, 16), (2, 16), (8, 8), (4, 128),
                                        (2, 128), (4, 4), (2, 8)])
@pytest.mark.parametrize("m", [9, 33, 512])
def test_qmatmul_groups_take_their_body(cuda, bits, group, m):
    k, n = 256, 96
    x, wp, s = case(bits, k, n, k // group, m, cuda)
    body = spec.plan_qmatmul(m, k, n, k // group, bits).body
    assert body == ("tc" if group % spec.qmm_tc_unit(bits) == 0 else "simt")
    before = dict(kernel.BODY_LAUNCHES["qmatmul"])
    check(kernel.qmatmul(x, wp, s, bits=bits), ref.qmatmul_ref(x, wp, s, bits))
    assert kernel.BODY_LAUNCHES["qmatmul"][body] == before[body] + 1


# K not a multiple of the 32-k stage (nor of 4: x read by 4-byte copies),
# N of 1, 7 (no 4-byte pieces of a packed row) and 200 (ragged tile)
@pytest.mark.parametrize("bits,k", [(4, 80), (2, 80), (8, 100), (8, 33), (4, 2050)])
@pytest.mark.parametrize("n", [1, 7, 200])
@pytest.mark.parametrize("m", [9, 32, 65])
def test_qmatmul_ragged_k_and_n(cuda, bits, k, n, m):
    x, wp, s = case(bits, k, n, 1, m, cuda)
    check(kernel.qmatmul(x, wp, s, bits=bits), ref.qmatmul_ref(x, wp, s, bits))


def test_both_tiled_bodies_launch(cuda):
    kernel.reset_launches()
    for group, m in ((128, 32), (128, 512), (4, 64)):  # short tile, wide tile, CUDA cores
        x, wp, s = case(4, 256, 64, 256 // group, m, cuda)
        kernel.qmatmul(x, wp, s, bits=4)
    xg, wpg, sg = grouped_case(4, 4, 256, 64, 1, 64, cuda)
    kernel.qmatmul_grouped(xg, wpg, sg, bits=4)
    kernel.qmatmul_grouped(xg[:, :8].contiguous(), wpg, sg, bits=4)
    torch.cuda.synchronize()
    assert kernel.BODY_LAUNCHES == {"qgemv": {"gemv_tc": 0, "gemv": 0},
                                    "qmatmul": {"tc": 2, "simt": 1},
                                    "qmatmul_grouped": {"tc": 1, "simt": 0, "gemv_tc": 1,
                                                        "gemv": 0}}
    assert kernel.LAUNCHES == {"qgemv": 0, "qmatmul": 3, "qmatmul_grouped": 2}


def test_qmatmul_is_deterministic(cuda):
    """Same shape, same plan, same summation order: the same bits."""
    for m in (32, 512):
        x, wp, s = case(4, 2048, 768, 1, m, cuda)
        a = kernel.qmatmul(x, wp, s, bits=4)
        b = kernel.qmatmul(x, wp, s, bits=4)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


# The decode bodies (M <= 8): (bits, group, k, n) over the brecq shapes,
# ragged N (200, 77, 7) and K (W8 100, W4 98, W2 100), groups of 16 and
# 128 k (tensor cores) and of 8 k (CUDA cores)
DEC_CASES = [(4, None, 768, 768), (4, None, 2048, 768), (2, None, 768, 2048),
             (8, None, 100, 200), (4, None, 98, 77), (2, None, 100, 7), (4, 128, 768, 768),
             (2, 128, 256, 200), (8, 16, 96, 77), (4, 16, 64, 7), (4, 8, 256, 96),
             (2, 8, 128, 77), (8, 8, 96, 40)]


def dec_body(group):
    return "gemv_tc" if group is None or group % spec.QMM_DEC_UNIT == 0 else "gemv"


@pytest.mark.parametrize("bits,group,k,n", DEC_CASES)
def test_qgemv_decode_bodies_match_plain(cuda, bits, group, k, n):
    g = 1 if group is None else k // group
    body = spec.plan_qgemv(k, n, g, bits).body
    assert body == dec_body(group)
    for m in range(1, 9):
        x, wp, s = case(bits, k, n, g, m, cuda, seed=m)
        before = dict(kernel.BODY_LAUNCHES["qgemv"])
        check(kernel.qgemv(x, wp, s, bits=bits), ref.qgemv_ref(x, wp, s, bits))
        assert kernel.BODY_LAUNCHES["qgemv"][body] == before[body] + 1


# (bits, group, k, n) at E 64: deepseek-moe-16b's expert shapes, W2,
# group 128, ragged N, and short groups
DEC_GROUPED = [(4, None, 2048, 1408), (4, None, 1408, 2048), (2, None, 2048, 1408),
               (4, 128, 2048, 1408), (8, 16, 256, 200), (4, None, 98, 77), (4, 8, 256, 96),
               (2, 8, 128, 77)]


@pytest.mark.parametrize("bits,group,k,n", DEC_GROUPED)
def test_qmatmul_grouped_decode_bodies_match_plain(cuda, bits, group, k, n):
    e = 64
    g = 1 if group is None else k // group
    body = spec.plan_qmatmul(8, k, n, g, bits, e, True).body
    assert body == dec_body(group)
    for m in range(1, 9):
        x, wp, s = grouped_case(bits, e, k, n, g, m, cuda, seed=m)
        before = dict(kernel.BODY_LAUNCHES["qmatmul_grouped"])
        check(kernel.qmatmul_grouped(x, wp, s, bits=bits), ref.qmm_grouped_ref(x, wp, s, bits))
        assert kernel.BODY_LAUNCHES["qmatmul_grouped"][body] == before[body] + 1


@pytest.mark.parametrize("e", [1, 64])
@pytest.mark.parametrize("bits,group", [(4, None), (2, 128), (8, None), (4, 8)])
def test_decode_bodies_are_batch_invariant_and_deterministic(cuda, e, bits, group):
    """Row m of a call equals the same call on row m alone, and on any
    prefix of the rows holding it, bit for bit; two calls give the same
    bits."""
    k, n = (2048, 768) if e == 1 else (1408, 2048)
    g = 1 if group is None else k // group
    if e == 1:
        x, wp, s = case(bits, k, n, g, 8, cuda)
        call = lambda a: kernel.qgemv(a.contiguous(), wp, s, bits=bits)  # noqa: E731
        rows = lambda a, i, j: a[i:j]  # noqa: E731
    else:
        x, wp, s = grouped_case(bits, e, k, n, g, 8, cuda)
        call = lambda a: kernel.qmatmul_grouped(a.contiguous(), wp, s, bits=bits)  # noqa: E731
        rows = lambda a, i, j: a[:, i:j]  # noqa: E731
    full, again = call(x), call(x)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for m in range(8):
        assert torch.equal(call(rows(x, m, m + 1)), rows(full, m, m + 1))
    for j in (3, 5):
        assert torch.equal(call(rows(x, 0, j)), rows(full, 0, j))


def test_short_groups_take_the_cuda_core_decode_bodies(cuda):
    kernel.reset_launches()
    x, wp, s = case(4, 256, 96, 32, 8, cuda)  # groups of 8 k
    check(kernel.qgemv(x, wp, s, bits=4), ref.qgemv_ref(x, wp, s, 4))
    xg, wpg, sg = grouped_case(2, 4, 128, 77, 16, 8, cuda)
    check(kernel.qmatmul_grouped(xg, wpg, sg, bits=2), ref.qmm_grouped_ref(xg, wpg, sg, 2))
    x2, wp2, s2 = case(4, 256, 96, 16, 8, cuda)  # groups of 16 k: tensor cores
    check(kernel.qgemv(x2, wp2, s2, bits=4), ref.qgemv_ref(x2, wp2, s2, 4))
    assert kernel.BODY_LAUNCHES["qgemv"] == {"gemv_tc": 1, "gemv": 1}
    assert kernel.BODY_LAUNCHES["qmatmul_grouped"]["gemv"] == 1


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
    assert kernel.LAUNCHES == {"qgemv": 1, "qmatmul": 1, "qmatmul_grouped": 0}
    # the plain backend launches nothing
    ops.qmm(x, qw, backend="torch")
    assert kernel.LAUNCHES == {"qgemv": 1, "qmatmul": 1, "qmatmul_grouped": 0}


def test_wrappers_reject_bad_operands(cuda):
    x, wp, s = case(4, 256, 64, 1, 8, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.qgemv(x.cpu(), wp, s, bits=4)
    with pytest.raises(TypeError, match="float32"):
        kernel.qgemv(x.double(), wp, s, bits=4)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.qmatmul(torch.cat([x] * 2, 1)[:, ::2], wp, s, bits=4)


def grouped_case(bits, e, k, n, g, m, device, seed=0, container=None):
    """Stacked codes (e, k*cbits/8, n) in a ``container``-bit field (default
    ``bits``), scales (e, g, n), x (e, m, k)."""
    rng = np.random.default_rng(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = torch.from_numpy(rng.integers(lo, hi + 1, size=(e, k, n)).astype(np.int8))
    wp = pack_int(codes, container or bits, axis=-2)
    s = rng.uniform(0.005, 0.02, size=(e, g, n)).astype(np.float32)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    return (torch.from_numpy(x).to(device), wp.to(device),
            torch.from_numpy(s).to(device))


def grouped_plain(x, wp, s, bits):
    return (ref.qmm_grouped_ref if x.shape[1] <= ops.DECODE_M_MAX
            else ref.qmm_grouped_dense_ref)(x, wp, s, bits)


# (bits, container, e, k, n, g): deepseek-moe-16b's expert shapes at E 8,
# ragged N (d_ff 96 of its reduced config, 1408 = 22 x 64), groups of 64,
# a W3 code in an int8 container, odd N (no 32-bit loads)
GROUPED = [(4, 4, 8, 2048, 1408, 1), (4, 4, 8, 1408, 2048, 1), (2, 2, 4, 64, 96, 1),
           (4, 4, 4, 256, 96, 4), (2, 2, 3, 128, 200, 2), (8, 8, 3, 96, 64, 1),
           (3, 8, 3, 128, 96, 1), (4, 4, 2, 128, 77, 1)]


@pytest.mark.parametrize("bits,container,e,k,n,g", GROUPED)
@pytest.mark.parametrize("m", [1, 4, 8, 9, 64])
def test_qmatmul_grouped_kernel_matches_plain(cuda, bits, container, e, k, n, g, m):
    x, wp, s = grouped_case(bits, e, k, n, g, m, cuda, container=container)
    before = kernel.LAUNCHES["qmatmul_grouped"]
    got = kernel.qmatmul_grouped(x, wp, s, bits=container)
    assert kernel.LAUNCHES["qmatmul_grouped"] == before + 1
    assert got.shape == (e, m, n)
    check(got, grouped_plain(x, wp, s, container))


def test_qmatmul_grouped_is_deterministic(cuda):
    for m in (8, 64):
        x, wp, s = grouped_case(4, 16, 1024, 1408, 1, m, cuda)
        a = kernel.qmatmul_grouped(x, wp, s, bits=4)
        b = kernel.qmatmul_grouped(x, wp, s, bits=4)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_qmm_grouped_launches_kernel_and_rejects(cuda):
    x, wp, s = grouped_case(4, 4, 128, 64, 1, 6, cuda)
    qw = ops.QuantizedLinear(wp, s, 4, 128)
    before = kernel.LAUNCHES["qmatmul_grouped"]
    xb = x.reshape(4, 2, 3, 128).transpose(0, 1)  # (B 2, E 4, C 3, K)
    got = ops.qmm(xb, qw)
    assert kernel.LAUNCHES["qmatmul_grouped"] == before + 1
    check(got, ops.qmm(xb, qw, backend="torch"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.qmatmul_grouped(x.cpu(), wp, s, bits=4)
    with pytest.raises(TypeError, match="float32"):
        kernel.qmatmul_grouped(x.double(), wp, s, bits=4)


def test_moe_capacity_combine_is_deterministic(cuda):
    """The capacity path (dispatch, grouped kernel, one-hot combine) gives
    the same bits on every run, W4 and FP."""
    from repro_torch.deploy import quantize_tree
    from repro_torch.models import moe
    from repro_torch.models.common import Ctx

    spec = moe.MoESpec(256, 128, 16, 4, n_shared=1, impl="capacity")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init(gen, spec)
    x = torch.randn((4, 48, 256), generator=gen, device=cuda)
    ctx = Ctx(cfg=None, positions=torch.zeros((4, 48), dtype=torch.int32, device=cuda))
    for params in (p, quantize_tree(p, 4)):
        runs = [moe.apply(ctx, params, spec, x) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])
    kernel.reset_launches()
    with torch.inference_mode():
        moe.apply(ctx, quantize_tree(p, 4), spec, x)
    assert kernel.LAUNCHES["qmatmul_grouped"] == 3


def kv_case(B, H, K, hd, S, device, *, seed=0, holes=False, empty_row=False):
    """int8 K/V from quantize_kv of random f32 K/V; kpos = arange(S) with
    optional -1 holes; cur in [S/4, S); with ``empty_row`` batch row 0
    has no valid slot."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    q = t(rng.standard_normal((B, H, hd)).astype(np.float32))
    k8, v8, ks, vs = kv_ops.quantize_kv(
        t(rng.standard_normal((B, S, K, hd)).astype(np.float32)),
        t(rng.standard_normal((B, S, K, hd)).astype(np.float32)))
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if holes:
        kpos[rng.random((B, S)) < 0.3] = -1
    if empty_row:
        kpos[0] = -1
    cur = rng.integers(S // 4, S, size=(B,)).astype(np.int32)
    return q, k8, v8, ks, vs, t(kpos), t(cur)


# (B, H, K, hd, S, window, holes, empty_row): the serve engine's decode
# shape, GQA at TinyLlama's width, MQA at hd 128, ragged S, a window,
# kpos holes, a row with no valid slot, and small odd shapes
KV_CASES = [
    (8, 12, 12, 64, 96, None, False, False),
    (2, 32, 4, 64, 2048, None, False, False),
    (3, 16, 1, 128, 512, None, False, False),
    (4, 12, 12, 64, 100, None, False, False),
    (2, 8, 2, 64, 256, 64, False, False),
    (2, 8, 2, 64, 300, None, True, False),
    (3, 4, 4, 32, 130, None, False, True),
    (1, 2, 1, 16, 1, None, False, False),
    (2, 6, 3, 112, 257, 7, True, False),
    (2, 4, 2, 256, 300, None, False, False),
]


@pytest.mark.parametrize("B,H,K,hd,S,window,holes,empty_row", KV_CASES)
def test_kv_decode_kernel_matches_plain(cuda, B, H, K, hd, S, window, holes,
                                        empty_row):
    args = kv_case(B, H, K, hd, S, cuda, holes=holes, empty_row=empty_row)
    before = kv_kernel.LAUNCHES["kv_decode"]
    got = kv_kernel.kv_decode(*args, window=window)
    assert kv_kernel.LAUNCHES["kv_decode"] == before + 1
    check(got, kv_decode_ref(*args, window=window))


def test_kv_decode_misaligned_views(cuda):
    """K/V views whose base is not 16-byte aligned are refused, not
    copied: the kernel reads the codes in 16-byte vectors."""
    q, k8, v8, ks, vs, kpos, cur = kv_case(2, 8, 2, 64, 200, cuda)
    kv = [torch.cat([x.reshape(-1)[:4], x.reshape(-1)])[4:].reshape(x.shape)
          for x in (k8, v8)]
    assert all(x.is_contiguous() and x.data_ptr() % 16 == 4 for x in kv)
    before = kv_kernel.LAUNCHES["kv_decode"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv_kernel.kv_decode(q, kv[0], v8, ks, vs, kpos, cur)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv_kernel.kv_decode(q, k8, kv[1], ks, vs, kpos, cur)
    assert kv_kernel.LAUNCHES["kv_decode"] == before


# kv_decode at head dim 120 (h2o-danube3-4b: 32 heads over 8 kv heads, G 4):
# the 8-byte body, with kpos holes and a window
@pytest.mark.parametrize("B,H,K,S,window,holes", [(8, 32, 8, 96, None, False),
                                                  (2, 32, 8, 1000, 64, True),
                                                  (3, 16, 4, 300, None, True),
                                                  (2, 4, 1, 257, 7, False)])
def test_kv_decode_head_dim_120_matches_plain(cuda, B, H, K, S, window, holes):
    args = kv_case(B, H, K, 120, S, cuda, holes=holes)
    before = dict(kv_kernel.BODY_LAUNCHES["kv_decode"])
    check(kv_kernel.kv_decode(*args, window=window), kv_decode_ref(*args, window=window))
    assert kv_kernel.BODY_LAUNCHES["kv_decode"]["v8"] == before["v8"] + 1


def test_kv_decode_body_follows_the_head_dim(cuda):
    """hd 64 keeps the 16-byte body, hd 120 and 24 take the 8-byte one,
    which reads codes that are 8-byte but not 16-byte aligned."""
    kv_kernel.reset_launches()
    for hd in (64, 120, 24):
        args = kv_case(2, 8, 2, hd, 200, cuda)
        check(kv_kernel.kv_decode(*args), kv_decode_ref(*args))
    assert kv_kernel.BODY_LAUNCHES["kv_decode"] == {"v16": 1, "v8": 2}
    q, k8, v8, ks, vs, kpos, cur = kv_case(2, 8, 2, 120, 200, cuda)
    kv = [torch.cat([x.reshape(-1)[:8], x.reshape(-1)])[8:].reshape(x.shape) for x in (k8, v8)]
    assert all(x.data_ptr() % 16 == 8 for x in kv)
    check(kv_kernel.kv_decode(q, *kv, ks, vs, kpos, cur), kv_decode_ref(q, *kv, ks, vs, kpos, cur))
    assert kv_kernel.BODY_LAUNCHES["kv_decode"] == {"v16": 1, "v8": 3}


def test_kv_decode_is_deterministic(cuda):
    args = kv_case(8, 12, 12, 64, 4096, cuda)
    a, b = kv_kernel.kv_decode(*args), kv_kernel.kv_decode(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_attend_int8_auto_launches_kernel(cuda):
    args = kv_case(2, 8, 2, 64, 96, cuda)
    before = kv_kernel.LAUNCHES["kv_decode"]
    check(kv_ops.attend_int8(*args), kv_decode_ref(*args))
    assert kv_kernel.LAUNCHES["kv_decode"] == before + 1
    kv_ops.attend_int8(*args, backend="torch")  # the plain version launches nothing
    assert kv_kernel.LAUNCHES["kv_decode"] == before + 1


def test_kv_decode_rejects_bad_operands(cuda):
    q, k8, v8, ks, vs, kpos, cur = kv_case(2, 8, 2, 64, 96, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kv_kernel.kv_decode(q.cpu(), k8, v8, ks, vs, kpos, cur)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kv_ops.attend_int8(q.cpu(), k8.cpu(), v8.cpu(), ks.cpu(), vs.cpu(),
                           kpos.cpu(), cur.cpu(), backend="cuda")
    with pytest.raises(TypeError, match="float32"):
        kv_kernel.kv_decode(q, k8, v8, ks.half(), vs, kpos, cur)
    with pytest.raises(TypeError, match="int8"):
        kv_kernel.kv_decode(q, k8.float(), v8, ks, vs, kpos, cur)
    with pytest.raises(ValueError, match="contiguous"):
        kv_kernel.kv_decode(q.transpose(0, 1).contiguous().transpose(0, 1),
                            k8, v8, ks, vs, kpos, cur)


# --- kv_decode's paged entry and its split of S ---------------------------------


def paged_case(B, H, K, hd, ps, mp, device, *, seed=0, holes=False, idle=0):
    """An int8 pool as the engine stores it (codes from quantize_kv of
    random f32 K/V, float16 scales; 1 + B * mp pages, page 0 the sink), block
    tables giving stream b the pages of positions 0..cur_b, shuffled, -1
    beyond (``holes``: about a third of them -1; the first ``idle`` rows all
    -1), q and cur in [S/4, S); and the dense view paged_view gathers."""
    from repro_torch.kernels.kvattn.ref import paged_view

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    P, S = 1 + B * mp, mp * ps
    k8, v8, ks, vs = kv_ops.quantize_kv(
        t(rng.standard_normal((P, ps, K, hd)).astype(np.float32)),
        t(rng.standard_normal((P, ps, K, hd)).astype(np.float32)))
    pool = {"k_pages": k8, "v_pages": v8, "k_scale": ks.half(), "v_scale": vs.half()}
    cur = rng.integers(S // 4, S, size=(B,)).astype(np.int32)
    bt = (1 + rng.permutation(P - 1)).reshape(B, mp).astype(np.int32)
    bt[np.arange(mp)[None] > (cur // ps)[:, None]] = -1
    if holes:
        bt[rng.random((B, mp)) < 0.3] = -1
    bt[:idle] = -1
    q = t(rng.standard_normal((B, H, hd)).astype(np.float32))
    bt, cur = t(bt), t(cur)
    gather, kpos = paged_view(pool, bt, ps)
    dense = (q, gather(k8), gather(v8), gather(pool["k_scale"]).float(),
             gather(pool["v_scale"]).float(), kpos, cur)
    return (q, pool["k_pages"], pool["v_pages"], pool["k_scale"], pool["v_scale"], bt,
            cur), dense


# (B, H, K, hd, page_size, max_pages, holes, idle rows): the engine's decode
# shape with two idle slots, GQA with holes, hd 120 (G 4), its long-context
# shape (S 2048), and a page size that does not divide the kernel's tile
PAGED_CASES = [(8, 12, 12, 64, 16, 6, False, 2), (3, 8, 2, 64, 4, 9, True, 1),
               (2, 32, 8, 120, 16, 5, True, 0), (4, 12, 12, 64, 16, 128, False, 1),
               (3, 4, 1, 120, 5, 40, True, 1)]


@pytest.mark.parametrize("B,H,K,hd,ps,mp,holes,idle", PAGED_CASES)
@pytest.mark.parametrize("split", [None, 1, 2])
def test_kv_decode_paged_equals_dense_on_gathered_view(cuda, B, H, K, hd, ps, mp, holes,
                                                       idle, split):
    """The paged entry computes the dense kernel on the view paged_view
    gathers, bit for bit, under one plan (its own, or a forced split)."""
    paged, dense = paged_case(B, H, K, hd, ps, mp, cuda, holes=holes, idle=idle)
    plan = None if split is None else spec.kv_plan(hd, H // K, 4, split)
    kv_kernel.reset_launches()
    got = kv_kernel.kv_decode_paged(*paged, page_size=ps, plan=plan)
    ref = kv_kernel.kv_decode(*dense, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    check(got, kv_decode_ref(*dense))
    assert kv_kernel.ENTRY_LAUNCHES["kv_decode"] == {"dense": 1, "paged": 1}
    assert kv_kernel.LAUNCHES["kv_decode"] == 2


@pytest.mark.parametrize("B,H,K,hd,S,window,holes", [(2, 8, 2, 64, 700, None, False),
                                                     (2, 32, 8, 120, 300, 64, True),
                                                     (3, 12, 12, 64, 2048, None, True)])
def test_kv_decode_every_plan_matches_plain(cuda, B, H, K, hd, S, window, holes):
    """Splits 1, 2, 4 and 8 and blocks of 4 and 8 warps all stay within the
    tolerance of the plain version."""
    args = kv_case(B, H, K, hd, S, cuda, holes=holes)
    want = kv_decode_ref(*args, window=window)
    kv_kernel.reset_launches()
    runs = 0
    for warps in spec.KV_WARPS:
        for split in spec.KV_SPLITS:
            plan = spec.kv_plan(hd, H // K, warps, split)
            check(kv_kernel.kv_decode(*args, window=window, plan=plan), want)
            runs += 1
    assert kv_kernel.SPLIT_LAUNCHES["kv_decode"] == {s: runs // 4 for s in spec.KV_SPLITS}


# the attention families' decode reads on the engine's paged entry:
# h2o-danube3-4b (32 heads over 8 of 120: the 8-byte body, G 4, its window
# of 4096 and a window that masks) and gemma3-12b (16 over 8 of 256: G 2,
# its local window of 1024 and one that masks), 8 slots, one idle
@pytest.mark.parametrize("H,K,hd,mp,window,body", [(32, 8, 120, 20, 4096, "v8"),
                                                   (32, 8, 120, 20, 100, "v8"),
                                                   (16, 8, 256, 20, 1024, "v16"),
                                                   (16, 8, 256, 20, 50, "v16")])
def test_kv_decode_paged_family_shapes_match_plain(cuda, H, K, hd, mp, window, body):
    (q, kp, vp, ks, vs, bt, cur), _ = paged_case(8, H, K, hd, 16, mp, cuda, idle=1)
    pool = {"k_pages": kp, "v_pages": vp, "k_scale": ks, "v_scale": vs}
    kv_kernel.reset_launches()
    got = kv_ops.attend_int8_paged(q, pool, bt, cur, 16, window=window, backend="cuda")
    want = kv_ops.attend_int8_paged(q, pool, bt, cur, 16, window=window, backend="torch")
    check(got, want)
    assert kv_kernel.BODY_LAUNCHES["kv_decode"][body] == 1
    assert kv_kernel.ENTRY_LAUNCHES["kv_decode"] == {"dense": 0, "paged": 1}


# the packed matmuls at the attention families' largest shapes: K2 over
# whisper-small's encoder (8 x 1,500 frames into its MLP) and the VLM's
# cross-attention K/V over 8 x 1,024 patches; K1 on the VLM's MLP, whose
# codes (117 MB at W4) do not fit in L2
@pytest.mark.parametrize("m,k,n", [(12000, 768, 3072), (8192, 8192, 1024)])
def test_qmatmul_family_shapes_match_plain(cuda, m, k, n):
    x, wp, s = case(4, k, n, 1, m, cuda)
    before = dict(kernel.BODY_LAUNCHES["qmatmul"])
    check(kernel.qmatmul(x, wp, s, bits=4), ref.qmatmul_ref(x, wp, s, 4))
    assert kernel.BODY_LAUNCHES["qmatmul"]["tc"] == before["tc"] + 1


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("k,n", [(8192, 28672), (28672, 8192)])
def test_qgemv_off_l2_shapes_match_plain(cuda, bits, k, n):
    x, wp, s = case(bits, k, n, 1, 8, cuda)
    before = dict(kernel.BODY_LAUNCHES["qgemv"])
    check(kernel.qgemv(x, wp, s, bits=bits), ref.qgemv_ref(x, wp, s, bits))
    assert kernel.BODY_LAUNCHES["qgemv"]["gemv_tc"] == before["gemv_tc"] + 1


# the recurrent families' new shapes: xlstm's w_if (2,048 x 8: N 8, half a
# decode block) and hymba's wB/wC (3,200 x 16), w_dt (3,200 x 3,200),
# in_proj (1,600 x 6,400) and untied head (1,600 x 32,001: N not a multiple
# of 16, so the narrower copies), at decode (K1) and the fixed batch's
# prefill (K2, M 512)
RECURRENT_QMM = [(2048, 8), (3200, 16), (3200, 3200), (1600, 6400), (1600, 32001)]


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("k,n", RECURRENT_QMM)
@pytest.mark.parametrize("m", [1, 8, 512])
def test_recurrent_family_shapes_match_plain(cuda, bits, k, n, m):
    x, wp, s = case(bits, k, n, 1, m, cuda)
    name, fn, plain, body = (("qgemv", kernel.qgemv, ref.qgemv_ref, "gemv_tc") if m <= 8
                             else ("qmatmul", kernel.qmatmul, ref.qmatmul_ref, "tc"))
    before = dict(kernel.BODY_LAUNCHES[name])
    check(fn(x, wp, s, bits=bits), plain(x, wp, s, bits))
    assert kernel.BODY_LAUNCHES[name][body] == before[body] + 1


def test_kv_decode_paged_is_deterministic(cuda):
    paged, _ = paged_case(8, 12, 12, 64, 16, 128, cuda, holes=True, idle=1)
    assert spec.plan_kv_decode(8, 12, 2048, 64).split > 1
    a = kv_kernel.kv_decode_paged(*paged, page_size=16)
    b = kv_kernel.kv_decode_paged(*paged, page_size=16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_engine_decode_reads_the_pool_without_gather(cuda, monkeypatch):
    """On the card an int8-pool engine's decode steps go through the paged
    entry and never gather the pool (paged_view raises inside a decode
    step); its chunked-prefill reads keep the gathered view."""
    from repro_torch.deploy import rtn_artifact
    from repro_torch.models import common as cm
    from repro_torch.models import get_model
    from repro_torch.serve_engine import EngineConfig, ServeEngine

    cfg, model = get_model("brecq_lm_100m", reduced=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    eng = ServeEngine(model, rtn_artifact(params, 4, None, cfg=cfg).params, EngineConfig(
        num_slots=3, page_size=4, num_pages=49, max_len=32, prefill_chunk=16))
    eng.compile()
    state = {"decoding": False, "gathers": 0}
    orig_view, orig_decode = cm.paged_view, eng._decode_c

    def view(*a, **kw):
        if state["decoding"]:
            raise AssertionError("an int8 decode step gathered the pool")
        state["gathers"] += 1
        return orig_view(*a, **kw)

    def decode(*a, **kw):
        state["decoding"] = True
        try:
            return orig_decode(*a, **kw)
        finally:
            state["decoding"] = False

    monkeypatch.setattr(cm, "paged_view", view)
    monkeypatch.setattr(kv_ops, "paged_view", view)
    eng._decode_c = decode
    kv_kernel.reset_launches()
    rng = np.random.default_rng(11)
    for uid, n in enumerate((5, 13, 9)):
        eng.submit(rng.integers(0, cfg.vocab, size=n), 6, uid=uid)
    eng.run()
    assert all(r.state == "done" for r in eng.requests.values())
    entries = kv_kernel.ENTRY_LAUNCHES["kv_decode"]
    assert entries["paged"] > 0 and entries["dense"] == 0
    assert state["gathers"] > 0  # the prefill chunks' reads


def test_kv_decode_paged_rejects_bad_pools(cuda):
    paged, _ = paged_case(2, 8, 2, 64, 4, 3, cuda)
    q, kp, vp, ks, vs, bt, cur = paged
    before = kv_kernel.LAUNCHES["kv_decode"]
    with pytest.raises(TypeError, match="float16"):
        kv_kernel.kv_decode_paged(q, kp, vp, ks.float(), vs, bt, cur, page_size=4)
    with pytest.raises(TypeError, match="int32"):
        kv_kernel.kv_decode_paged(q, kp, vp, ks, vs, bt.long(), cur, page_size=4)
    off = torch.cat([kp.reshape(-1)[:4], kp.reshape(-1)])[4:].reshape(kp.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv_kernel.kv_decode_paged(q, off, vp, ks, vs, bt, cur, page_size=4)
    off = torch.cat([ks.reshape(-1)[:1], ks.reshape(-1)])[1:].reshape(ks.shape)
    with pytest.raises(ValueError, match="4-byte aligned"):
        kv_kernel.kv_decode_paged(q, kp, vp, off, vs, bt, cur, page_size=4)
    with pytest.raises(spec.KernelSpecError, match="page"):
        kv_kernel.kv_decode_paged(q, kp, vp, ks, vs, bt, cur, page_size=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kv_kernel.kv_decode_paged(q.cpu(), kp, vp, ks, vs, bt, cur, page_size=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kv_ops.attend_int8_paged(q.cpu(), {"k_pages": kp.cpu(), "v_pages": vp.cpu(),
                                           "k_scale": ks.cpu(), "v_scale": vs.cpu()},
                                 bt.cpu(), cur.cpu(), 4, backend="cuda")
    assert kv_kernel.LAUNCHES["kv_decode"] == before


def test_engine_kernel_path_on_card(cuda):
    """A reduced W4 engine run over an int8 pool launches all three kernels
    and hands every page back."""
    from repro_torch.deploy import rtn_artifact
    from repro_torch.models import get_model
    from repro_torch.serve_engine import EngineConfig, ServeEngine

    cfg, model = get_model("brecq_lm_100m", reduced=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    art = rtn_artifact(params, 4, None, cfg=cfg)
    eng = ServeEngine(model, art.params, EngineConfig(
        num_slots=3, page_size=4, num_pages=49, max_len=32, prefill_chunk=16))
    eng.compile()
    kernel.reset_launches()
    kv_kernel.reset_launches()
    rng = np.random.default_rng(11)
    for uid, n in enumerate((5, 13, 9)):
        eng.submit(rng.integers(0, cfg.vocab, size=n), 6, uid=uid)
    eng.run()
    assert all(r.state == "done" for r in eng.requests.values())
    eng.assert_no_leaks()
    assert kv_kernel.LAUNCHES["kv_decode"] > 0
    assert kernel.LAUNCHES["qgemv"] > 0 and kernel.LAUNCHES["qmatmul"] > 0


def test_moe_engine_kernel_path_on_card(cuda):
    """A reduced deepseek-moe-16b W4 engine run (capacity routing) over an
    int8 pool launches the grouped kernel and kv_decode and hands every
    page back."""
    from repro_torch.deploy import rtn_artifact
    from repro_torch.models import get_model
    from repro_torch.serve_engine import EngineConfig, ServeEngine

    cfg, model = get_model("deepseek_moe_16b", reduced=True, moe_impl="capacity")
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    art = rtn_artifact(params, 4, None, cfg=cfg)
    eng = ServeEngine(model, art.params, EngineConfig(
        num_slots=3, page_size=4, num_pages=49, max_len=32, prefill_chunk=16))
    eng.compile()
    kernel.reset_launches()
    kv_kernel.reset_launches()
    rng = np.random.default_rng(11)
    for uid, n in enumerate((5, 13, 9)):
        eng.submit(rng.integers(0, cfg.vocab, size=n), 6, uid=uid)
    eng.run()
    assert all(r.state == "done" for r in eng.requests.values())
    eng.assert_no_leaks()
    assert kv_kernel.LAUNCHES["kv_decode"] > 0
    assert kernel.LAUNCHES["qmatmul_grouped"] > 0


# --- fakequant (K5) ------------------------------------------------------------

FQ_CASES = [(768, 768), (768, 2048), (2048, 768), (100, 300), (100, 301), (1, 7),
            (33, 4)]


def fq_case(k, n, per_weight, device, bits=2, seed=0):
    from repro_torch.core.quantizer import QConfig, QState

    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=device) * 0.02
    v = torch.randn((k, n), generator=gen, device=device) * 2
    cfg = QConfig(bits=bits, channel_axis=-1)
    s = torch.clamp_min(w.abs().amax(0, keepdim=True) / cfg.qmax, 1e-8)
    if per_weight:
        s = (s * (torch.rand((k, n), generator=gen, device=device) + 0.5)).contiguous()
    return w, v, s, cfg, QState(s, torch.zeros_like(s))


@pytest.mark.parametrize("k,n", FQ_CASES)
@pytest.mark.parametrize("per_weight", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
def test_fakequant_kernel_matches_plain(cuda, k, n, per_weight, bits):
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.fakequant.ref import fakequant_ref

    w, v, s, cfg, _ = fq_case(k, n, per_weight, cuda, bits)
    for hard in (True, False):
        before = fq_kernel.LAUNCHES["fakequant"]
        got = fq_kernel.fakequant(w, v, s, qmin=cfg.qmin, qmax=cfg.qmax, hard=hard)
        assert fq_kernel.LAUNCHES["fakequant"] == before + 1
        want = fakequant_ref(w, v, s, cfg.qmin, cfg.qmax, hard)
        torch.cuda.synchronize()
        if hard:
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("k,n", [(2048, 8), (3200, 16), (1600, 32001), (1600, 6400)])
@pytest.mark.parametrize("bits", [2, 4])
def test_fakequant_recurrent_family_shapes_match_plain(cuda, k, n, bits):
    """The recurrent families' calibrated leaves: N 8 and 16 (the vec4
    body), 32,001 (the scalar body), K 1,600 and 3,200."""
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.fakequant.ref import fakequant_ref

    w, v, s, cfg, _ = fq_case(k, n, False, cuda, bits)
    for hard in (True, False):
        got = fq_kernel.fakequant(w, v, s, qmin=cfg.qmin, qmax=cfg.qmax, hard=hard)
        want = fakequant_ref(w, v, s, cfg.qmin, cfg.qmax, hard)
        torch.cuda.synchronize()
        if hard:
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_fakequant_rejects_uncovered_configs(cuda):
    import dataclasses

    from repro_torch.kernels.fakequant import ops as fq_ops
    from repro_torch.kernels.spec import KernelSpecError

    w, v, s, cfg, st = fq_case(64, 48, False, cuda)
    with pytest.raises(KernelSpecError, match=r"\(K, N\)"):
        fq_ops.adaround_forward(w[0], v[0], st, cfg, hard=True)
    per_expert = type(st)(torch.stack([s, s]), st.zero_point)
    with pytest.raises(KernelSpecError, match="shared across its leading dims"):
        fq_ops.adaround_forward(torch.stack([w, w]), torch.stack([v, v]), per_expert,
                                cfg, hard=True)
    for bad in (dataclasses.replace(cfg, group_size=16),
                dataclasses.replace(cfg, symmetric=False)):
        with pytest.raises(KernelSpecError, match="symmetric per-channel"):
            fq_ops.adaround_forward(w, v, st, bad, hard=True)
    with pytest.raises(TypeError, match="float32"):
        fq_ops.adaround_forward(w.double(), v, st, cfg, hard=True)
    strided = torch.cat([w, w], 1)[:, ::2]  # (64, 48), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fq_ops.adaround_forward(strided, v, st, cfg, hard=True)


def test_hard_quant_auto_launches_kernel(cuda):
    from repro_torch.core import adaround
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.fakequant import ops as fq_ops

    w, v, s, cfg, st = fq_case(768, 2048, False, cuda)
    before = fq_kernel.LAUNCHES["fakequant"]
    got = fq_ops.adaround_forward(w, v, st, cfg, hard=True)
    hq = adaround.hard_quant(w, v, st, cfg)
    assert fq_kernel.LAUNCHES["fakequant"] == before + 2
    hard = (v >= 0).to(w.dtype)
    want = torch.clamp(torch.floor(w / st.scale) + hard + st.zero_point, cfg.qmin,
                       cfg.qmax)
    want = (want - st.zero_point) * st.scale
    assert torch.equal(got, want) and torch.equal(hq, want)
    # grouped configs take the plain formula, by config
    import dataclasses

    g = dataclasses.replace(cfg, group_size=128)
    from repro_torch.core.quantizer import init_qstate

    gst = init_qstate(w, g)
    adaround.hard_quant(w, v, gst, g)
    assert fq_kernel.LAUNCHES["fakequant"] == before + 2


def expert_case(e, k, n, device, bits=2, seed=0):
    """A stack of ``e`` experts' (K, N) weights with one scale per output
    channel shared across experts, as calibration's QState has it."""
    from repro_torch.core.quantizer import QConfig, QState

    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((e, k, n), generator=gen, device=device) * 0.02
    v = torch.randn((e, k, n), generator=gen, device=device) * 2
    cfg = QConfig(bits=bits, channel_axis=-1)
    s = torch.clamp_min(w.abs().amax((0, 1), keepdim=True) / cfg.qmax, 1e-8)
    return w, v, cfg, QState(s, torch.zeros_like(s))


@pytest.mark.parametrize("e,k,n", [(64, 2048, 1408), (64, 1408, 2048), (8, 64, 96),
                                   (3, 33, 7)])
def test_fakequant_expert_stack_matches_plain(cuda, e, k, n):
    """K5 on a stack of experts (E, K, N), run as its (E*K, N) view: bit
    for bit the plain hard_quant formula, and each expert's slice equal to
    the kernel on that expert alone."""
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.fakequant import ops as fq_ops

    w, v, cfg, st = expert_case(e, k, n, cuda)
    before = dict(fq_kernel.VIEW_LAUNCHES)
    got = fq_ops.adaround_forward(w, v, st, cfg, hard=True)
    assert fq_kernel.VIEW_LAUNCHES["experts"] == before["experts"] + 1
    hard = (v >= 0).to(w.dtype)
    want = torch.clamp(torch.floor(w / st.scale) + hard, cfg.qmin, cfg.qmax) * st.scale
    torch.cuda.synchronize()
    assert got.shape == w.shape and torch.equal(got, want)
    one = fq_ops.adaround_forward(w[e - 1].contiguous(), v[e - 1].contiguous(),
                                  type(st)(st.scale[0], st.zero_point[0]), cfg, hard=True)
    assert torch.equal(one, got[e - 1])
    soft = fq_ops.adaround_forward(w, v, st, cfg, hard=False)
    ref = fq_ops.adaround_forward(w, v, st, cfg, hard=False, backend="torch")
    torch.cuda.synchronize()
    assert float((soft - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_hard_quant_routes_expert_stacks_to_the_kernel(cuda):
    import dataclasses

    from repro_torch.core import adaround
    from repro_torch.kernels.fakequant import kernel as fq_kernel

    w, v, cfg, st = expert_case(8, 64, 96, cuda)
    before = fq_kernel.LAUNCHES["fakequant"], fq_kernel.VIEW_LAUNCHES["experts"]
    got = adaround.hard_quant(w, v, st, cfg)
    assert (fq_kernel.LAUNCHES["fakequant"], fq_kernel.VIEW_LAUNCHES["experts"]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, adaround.hard_quant(w.cpu(), v.cpu(), type(st)(
        st.scale.cpu(), st.zero_point.cpu()), cfg).to(cuda))
    # per-expert scales take the plain formula, by the scale's shape
    pe = torch.clamp_min(w.abs().amax(1, keepdim=True) / cfg.qmax, 1e-8)
    adaround.hard_quant(w, v, type(st)(pe, torch.zeros_like(pe)), cfg)
    adaround.hard_quant(w, v, st, dataclasses.replace(cfg, symmetric=False))
    assert fq_kernel.LAUNCHES["fakequant"] == before[0] + 1


def test_measure_cost_table_times_the_cuda_tiers(cuda):
    from repro_torch.deploy.budget import install_dispatch, measure_cost_table

    shapes = {"body.0/a": (768, 768), "body.1/a": (768, 768), "body.0/b": (2048, 768),
              "moe.0/w": (8, 256, 128)}
    kernel.reset_launches()
    table = measure_cost_table(shapes, m=8, inner=2, reps=2, device=cuda)
    assert table.backend == "cuda"
    assert table.meta["device_name"] == torch.cuda.get_device_name(cuda)
    # 2 dense shapes x 3 containers x 2 tiers, 1 stack x 3 containers; each
    # timing is 1 warm-up + the inner calls captured in a CUDA graph
    calls = 1 + 2
    assert kernel.LAUNCHES["qgemv"] == 2 * 3 * calls
    assert kernel.LAUNCHES["qmatmul"] == 2 * 3 * calls
    assert kernel.LAUNCHES["qmatmul_grouped"] == 3 * calls
    assert all(c > 0 for c in table.costs.values())
    assert table.cost("body.0/a", 4) == table.cost("body.1/a", 4)
    assert table.tiers[("moe.0/w", 2)] == "grouped"
    try:
        install_dispatch(table)
        ops.reset_tier_counts()
        x = torch.randn(8, 768, device=cuda)
        qw = ops.QuantizedLinear(*case(4, 768, 768, 1, 8, cuda)[1:], 4, 768)
        ops.qmm(x, qw)
        assert ops.TIER_COUNTS[table.dispatch["768,768,4"]] == 1
    finally:
        install_dispatch(None)


def test_serve_budget_bytes_on_card(cuda):
    from repro_torch.deploy.budget import rtn_mixed_artifact, weight_shapes
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    cfg, model = get_model("brecq_lm_100m", reduced=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    shapes = weight_shapes(params, cfg.n_layers)
    lo = rtn_mixed_artifact(params, {p: 2 for p in shapes}, cfg=cfg).nbytes()
    hi = rtn_mixed_artifact(params, {p: 8 for p in shapes}, cfg=cfg).nbytes()
    budget = (lo + hi) // 2
    kernel.reset_launches()
    out = serve.main(["--reduced", "--budget-bytes", str(budget), "--batch", "2",
                      "--prompt-len", "8", "--gen-len", "4", "--no-compare-fp"],
                     params=params)
    assert out["artifact_bytes"] <= budget
    assert out["tokens"].shape == (2, 4) and out["tokens"].is_cuda
    assert kernel.LAUNCHES["qgemv"] > 0 and kernel.LAUNCHES["qmatmul"] > 0


def test_two_block_full_width_calibration_on_card(cuda):
    import dataclasses

    from repro_torch.core import ReconConfig, quantize
    from repro_torch.data import Corpus, CorpusConfig, make_batches
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config("brecq_lm_100m"), n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    calib = make_batches(Corpus(CorpusConfig(vocab=cfg.vocab)), 2, 8, 64, seed=1)
    fq_kernel.reset_launches()
    res = quantize(model, params, calib, ReconConfig(w_bits=2, iters=5, calib_bs=8))
    retries = res.stats["unit_retries"]
    assert fq_kernel.LAUNCHES["fakequant"] == 2 * 2 * 7 + 2 * 7 + 14 * retries
    assert res.params_q["body"]["sub0"]["attn"]["wq"]["w"].is_cuda
    assert all(bool(torch.isfinite(v).all()) for v in res.v.values())
    assert res.stats["calib_iters_per_s"] > 0


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_350m"])
def test_recurrent_families_serve_packed_on_card(cuda, arch):
    """Reduced hymba (prompt past its window of 32) and xlstm, RTN W4 on the
    card: prefill, then decode steps of the forward's own tokens, each
    within 1e-4 * max|logit| of the packed forward at that position (the
    recurrent state written in place at every step), through K1 and K2."""
    from repro_torch.deploy import rtn_artifact
    from repro_torch.models import get_model

    cfg, model = get_model(arch, reduced=True)
    art = rtn_artifact(model.init(torch.Generator(device=cuda).manual_seed(0)), 4, None,
                       cfg=cfg)
    hook = art.hook()
    S, k = 48, 6
    toks = torch.randint(0, cfg.vocab, (2, S), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(cuda)
    kernel.reset_launches()
    with torch.inference_mode():
        full, _ = model.forward(art.params, {"tokens": toks}, hook)
        cache = model.init_cache(2, S, torch.float32, cuda)
        _, cache = model.prefill(art.params, {"tokens": toks[:, :S - k]}, cache, hook)
        for t in range(S - k, S):
            pos = torch.full((2,), t, dtype=torch.int32, device=cuda)
            lg, cache = model.decode_step(art.params, toks[:, t:t + 1], cache, pos, hook)
            check(lg, full[:, t])
    assert kernel.LAUNCHES["qgemv"] > 0 and kernel.LAUNCHES["qmatmul"] > 0
