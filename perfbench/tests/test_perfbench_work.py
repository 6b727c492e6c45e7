"""The benchmark's frozen arithmetic equals the program's today."""
import pytest

from perfbench import port
from perfbench.work import flops, kernels

QMM = [(1, 8, 6144, 6144, 4, 1), (1, 512, 6144, 16384, 4, 1), (1, 32, 16384, 6144, 4, 48),
       (4, 64, 768, 2048, 2, 12), (1, 1, 6144, 92544, 8, 1)]


@pytest.mark.parametrize("dims", QMM)
def test_qmm_work(dims):
    from repro_torch.kernels import record

    w = record.qmm_work("qmatmul", *dims)
    assert kernels.qmm_work(*dims) == (w.flops, w.bytes)


@pytest.mark.parametrize("dims", [(768, 768, 1), (6144, 16384, 1), (3, 5, 3)])
def test_fq_work(dims):
    from repro_torch.kernels import record

    w = record.fq_work(*dims)
    assert kernels.fq_work(*dims) == (w.flops, w.bytes)


CONFIGS = ["internlm2_20b"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("layers", [1, 8])
def test_model_flops(name, layers):
    from perfbench import harness
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import ShapeSpec

    cfg = dict(harness.load_config(harness.load_spec(), name), num_hidden_layers=layers)
    arch = port.arch_config(cfg)
    assert flops.active_params(cfg) == roofline.active_params(arch)
    for kind in ("train", "prefill"):
        shape = ShapeSpec("s", 2048, 8, kind)
        assert flops.model_flops(cfg, kind, 8 * 2048) == pytest.approx(
            roofline.model_flops(arch, shape, 1), rel=1e-12)


TINY = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 3, "vocab_size": 256,
        "rope_theta": 1e6, "tie_word_embeddings": False, "hidden_act": "silu",
        "rms_norm_eps": 1e-6}


def test_layerwise_packing():
    """The serving driver's packing, one layer at a time, is the program's
    ``rtn_artifact`` of the whole tree made from the same seed."""
    import torch

    from perfbench import harness, weights
    from repro_torch.deploy import rtn_artifact

    drv = harness.load_driver("serve")
    mix = harness.load_mix("serve_code")
    cpu = torch.device("cpu")
    _model, got, _hook = drv.pack(TINY, mix, 2**31 + 7, cpu)
    arch, model = port.model(TINY)
    whole = rtn_artifact(weights.make_params(model, 2**31 + 7, cpu), 4, None, cfg=arch).params
    a, b = dict(drv._leaves(got)), dict(drv._leaves(whole))
    assert list(a) == list(b)
    for p in a:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p
