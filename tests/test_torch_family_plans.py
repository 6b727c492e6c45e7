"""Launch plans (``kernels/spec.py``) at every shape the attention families
and the recurrent families give the kernels, at full width: whisper-small,
llama-3.2-vision-90b, gemma3-12b, h2o-danube3-4b, internlm2-20b, and
xlstm-350m and hymba-1.5b (gate projections of N 8 and 16, a head of N
32,001).

Every packed linear of each config takes a tensor-core plan at decode
(``plan_qgemv``, M <= 8) and at prefill (``plan_qmatmul``: the engine's
32-row chunk, the fixed batch's 8 x 64 rows, whisper's 8 x 1,500 encoder
frames, the VLM's 8 x 1,024 patches) whose shared memory fits a block and
whose grid stays within CUDA's limits; every self-attention layer's decode
read takes a ``plan_kv_decode`` on the paged entry's shapes, with the body
its head dim calls for (``v8`` at 120, ``v16`` at 128 and 256).
"""
import pytest

from repro_torch.kernels import spec
from repro_torch.models import get_config

ARCHS = ["whisper_small", "llama32_vision_90b", "gemma3_12b", "h2o_danube3_4b",
         "internlm2_20b"]


def linear_shapes(cfg) -> set:
    """(K, N) of every packed linear: attention, MLP and the untied head."""
    d, hd = cfg.d_model, cfg.hd
    shapes = {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
              (d, cfg.d_ff), (cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        shapes.add((d, cfg.vocab))
    return shapes


def prefill_rows(cfg) -> list:
    rows = [32, 8 * 64]
    if cfg.enc_dec:
        rows.append(8 * 1500)
    if cfg.family == "vlm":
        rows.append(8 * cfg.n_patches)
    return rows


CASES = [(arch, k, n) for arch in ARCHS for k, n in sorted(linear_shapes(get_config(arch)))]


def grid_ok(plan) -> bool:
    gx, gy, gz = plan.grid
    return gx < 2 ** 31 and gy <= 65535 and gz <= 65535 and plan.blocks >= 1


@pytest.mark.parametrize("arch,k,n", CASES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_every_linear_takes_a_tensor_core_plan(arch, k, n, bits):
    dec = spec.plan_qgemv(k, n, 1, bits)
    assert dec.body == "gemv_tc" and dec.smem <= spec.SMEM_PER_BLOCK and grid_ok(dec)
    for m in prefill_rows(get_config(arch)):
        pre = spec.plan_qmatmul(m, k, n, 1, bits)
        assert pre.body == "tc" and pre.smem <= spec.SMEM_PER_BLOCK and grid_ok(pre)
        assert pre.tile == ("short" if m <= spec.QMM_SHORT_M else "wide")


def test_the_slice_s_headline_shapes():
    """whisper's encoder MLP at M 12,000; the VLM's cross-attention K/V
    over its patches at M 8,192, K 8,192; the VLM's MLP at decode, 8,192 x
    28,672 (117 MB of W4 codes: the 128-column decode tile fills the card)."""
    enc = spec.plan_qmatmul(12000, 768, 3072, 1, 4)
    assert (enc.tile, enc.grid[:2]) == ("wide", (24, 188))
    xkv = spec.plan_qmatmul(8192, 8192, 1024, 1, 4)
    assert (xkv.tile, xkv.grid[:2]) == ("wide", (8, 128))
    for bits in (4, 2):
        mlp = spec.plan_qgemv(8192, 28672, 1, bits)
        assert (mlp.tile, mlp.grid) == ("dec128", (224, 1, 1))
        assert spec.plan_qgemv(28672, 8192, 1, bits).tile == "dec16"


@pytest.mark.parametrize("arch", ["gemma3_12b", "h2o_danube3_4b", "internlm2_20b",
                                  "whisper_small", "llama32_vision_90b"])
@pytest.mark.parametrize("S", [96, 272, 2048, 4096])
def test_every_decode_read_takes_a_kv_plan(arch, S):
    cfg = get_config(arch)
    G = cfg.n_heads // cfg.n_kv_heads
    plan = spec.plan_kv_decode(8, cfg.n_kv_heads, S, cfg.hd, G)
    assert plan.body == {120: "v8"}.get(cfg.hd, "v16")
    assert plan.rows * plan.chunks >= G and plan.split in spec.KV_SPLITS
    assert spec.kv_smem(plan.rows, cfg.hd, plan.warps, 16) <= spec.SMEM_PER_BLOCK
    P, mp, K = 1 + 8 * (S // 16), S // 16, cfg.n_kv_heads
    sp = spec.describe_kv_decode_paged((8, cfg.n_heads, cfg.hd), (P, 16, K, cfg.hd),
                                       (P, 16, K, cfg.hd), (P, 16, K), (P, 16, K),
                                       (8, mp), (8,), 16)
    assert sp["S"] == S and sp["hd"] == cfg.hd


def test_danube_and_gemma3_decode_bodies():
    """The engine phases' reads: danube's 8-byte body at G 4, gemma3's
    16-byte body at head dim 256 (KV_HD_MAX), G 2."""
    assert spec.kv_decode_body(120) == "v8" and spec.kv_decode_body(256) == "v16"
    assert spec.KV_HD_MAX == 256
    danube = spec.plan_kv_decode(8, 8, 272, 120, 4)
    gemma = spec.plan_kv_decode(8, 8, 272, 256, 2)
    assert (danube.rows, danube.chunks) == (4, 1)
    assert (gemma.rows, gemma.chunks, gemma.units) == (2, 1, 4)


def recurrent_shapes(arch) -> set:
    """(K, N) of every packed linear of the recurrent families at full
    width: xlstm's mLSTM (in_proj, wq/wk/wv, w_if with N = 2 x heads,
    out_proj) and sLSTM (w_in, out_proj); hymba's attention, SSM (in_proj,
    wB/wC with N = d_state, w_dt, out_proj) and MLP; both untied heads."""
    cfg = get_config(arch)
    d, V = cfg.d_model, cfg.vocab
    if arch == "xlstm_350m":
        di = int(d * cfg.xlstm_expansion)
        return {(d, 2 * di), (di, di), (di, 2 * cfg.n_heads), (di, d), (d, 4 * di), (d, V)}
    di = int(d * cfg.ssm_expansion)
    return linear_shapes(cfg) | {(d, 2 * di), (di, cfg.ssm_state), (di, di), (di, d)}


RECURRENT_CASES = [(arch, k, n) for arch in ("xlstm_350m", "hymba_1_5b")
                   for k, n in sorted(recurrent_shapes(arch))]


@pytest.mark.parametrize("arch,k,n", RECURRENT_CASES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_every_recurrent_linear_takes_a_tensor_core_plan(arch, k, n, bits):
    """Decode at M <= 8, the fixed batch's prefill at 8 x 64 rows and a
    calibration minibatch's 8 x 128."""
    dec = spec.plan_qgemv(k, n, 1, bits)
    assert dec.body == "gemv_tc" and dec.smem <= spec.SMEM_PER_BLOCK and grid_ok(dec)
    for m in (8 * 64, 8 * 128):
        pre = spec.plan_qmatmul(m, k, n, 1, bits)
        assert pre.body == "tc" and pre.tile == "wide"
        assert pre.smem <= spec.SMEM_PER_BLOCK and grid_ok(pre)


def test_the_recurrent_slice_s_narrow_and_ragged_shapes():
    """The shapes no earlier path gave K1: xlstm's w_if (N 8) and hymba's
    wB/wC (N 16) in one decode block of 16 columns, and hymba's head (N
    32,001, not a multiple of 16) on the 128-column decode tile."""
    assert {(k, n) for k, n in recurrent_shapes("xlstm_350m") if n < 16} == {(2048, 8)}
    assert (3200, 16) in recurrent_shapes("hymba_1_5b")
    for k, n in ((2048, 8), (3200, 16)):
        plan = spec.plan_qgemv(k, n, 1, 4)
        assert (plan.tile, plan.grid) == ("dec16", (1, 1, 1))
    head = spec.plan_qgemv(1600, 32001, 1, 4)
    assert (head.tile, head.grid) == ("dec128", (251, 1, 1))
