"""Port parity: the dense configs gemma3-12b (head dim 16 reduced, qk-norm,
GELU, local:global groups, untied head), h2o-danube3-4b (sliding window)
and internlm2-20b against the JAX package, on the CPU, at ``reduced()``.

The same numpy-made params go through both packages: forward logits and
loss within 1e-4; prefill + greedy decode tokens identical, FP and packed
W4, with prompts that overflow gemma3's local ring; the cache invariant;
artifacts across packages with equal digests; and ``serve --engine`` (int8
paged pool, staggered streams) token for token against the JAX engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro_torch.deploy import QuantizedArtifact, rtn_artifact
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import get_model
from test_torch_families import (both, close, decode_matches_forward, forward_both,
                                 greedy_both, jb, models, np_batch, np_params, tb)

ARCHS = ["gemma3_12b", "h2o_danube3_4b", "internlm2_20b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, jmodel, model = models(request.param)
    return request.param, cfg, jmodel, model, np_params(jmodel)


def test_full_configs_build_with_published_numbers():
    for arch, (layers, hd, window, tie) in {
            "gemma3_12b": (48, 256, None, False), "h2o_danube3_4b": (24, 120, 4096, False),
            "internlm2_20b": (48, 128, None, False)}.items():
        cfg, model = get_model(arch)
        assert (cfg.n_layers, cfg.hd, cfg.window, cfg.tie_embeddings) == (layers, hd, window, tie)
    cfg, model = get_model("gemma3-12b")  # the published name, as an alias
    assert [s.window for s in model.stacks[0].subs] == [1024] * 5 + [None]
    assert model.stacks[0].n == 8 and cfg.qk_norm and cfg.vocab == 262144


def test_forward_and_loss_match_jax(pair):
    _, cfg, jmodel, model, p = pair
    jp, tp = both(p)
    batch = np_batch(cfg, 2, 24)
    got, want = forward_both(jmodel, model, jp, tp, batch)
    close(got, want)
    with torch.no_grad():
        loss = model.loss(tp, tb(batch))
    close(float(loss), float(jmodel.loss(jp, jb(batch), remat="none")))


@pytest.mark.parametrize("bits", [None, 4])
def test_prefill_and_greedy_decode_match_jax(pair, bits):
    """Prompts of 20: past gemma3's local window of 16 (the ring keeps the
    tail)."""
    _, cfg, jmodel, model, p = pair
    jp, tp = both(p, bits)
    (tl, jl), (tt, jt) = greedy_both(jmodel, model, jp, tp, np_batch(cfg, 2, 20), steps=4)
    close(tl, jl)
    np.testing.assert_array_equal(tt, jt)


def test_decode_matches_forward(pair):
    _, cfg, _, model, p = pair
    _, tp = both(p)
    decode_matches_forward(model, tp, np_batch(cfg, 2, 24))


def test_artifacts_cross_packages(pair, tmp_path):
    _, cfg, jmodel, model, p = pair
    jart = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=cfg)
    jart.save(str(tmp_path / "j"))
    rtn_artifact(params_from_numpy(p, device="cpu"), 4, None, cfg=cfg).save(str(tmp_path / "t"))
    got = QuantizedArtifact.load(str(tmp_path / "j"), verify=True)
    back = JArtifact.load(str(tmp_path / "t"), verify=True)
    assert got.manifest["content_digest"] == back.manifest["content_digest"]
    assert back.manifest["family"] == "dense" and got.params["head"]["w"].dtype == torch.int8
    batch = np_batch(cfg, 2, 8)
    with torch.no_grad():
        logits, _ = model.forward(got.params, tb(batch), got.hook())
    want, _ = jmodel.forward(back.params, jb(batch), back.hook(), remat="none")
    close(logits.numpy(), want)


def jax_engine_tokens(arch, p, kv_dtype, seed, n=6):
    """The JAX engine driven as ``serve --engine`` drives the port's:
    ``serve.engine_streams``' draws, an RTN W4 artifact, the worst-case
    pool of ``serve.engine_config``."""
    from repro.data import Corpus as JCorpus
    from repro.data import CorpusConfig as JCorpusConfig
    from repro.models import get_model as j_get_model
    from repro.serve_engine import EngineConfig, ServeEngine

    jcfg, jmodel = j_get_model(arch, reduced=True)
    art = j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, None, cfg=jcfg)
    eng = ServeEngine(jmodel, art.params, EngineConfig(
        num_slots=3, page_size=16, num_pages=1 + 3 * 2, max_len=26,
        prefill_chunk=20, kv_dtype=kv_dtype, backend="xla"), quant=art.hook())
    rng = np.random.default_rng(seed)
    corpus = JCorpus(JCorpusConfig(vocab=jcfg.vocab))
    arrivals = sorted(int(a) for a in rng.integers(0, 4 * n, n))
    plens = rng.integers(10, 21, n)
    gens = rng.integers(3, 7, n)
    prompts = [corpus.sample(1, int(plens[i]), seed=seed + i)[0] for i in range(n)]
    nxt = 0
    while nxt < n or eng.pending():
        while nxt < n and arrivals[nxt] <= eng.tick:
            eng.submit(prompts[nxt], int(gens[nxt]))
            nxt += 1
        eng.step()
    return {u: list(r.generated) for u, r in eng.requests.items()}


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_serve_engine_matches_jax_engine(pair, kv_dtype):
    """Prompts of 10-20 tokens, 3-6 generated: streams past gemma3's local
    window of 16 on the paged pool."""
    arch, cfg, jmodel, model, _ = pair
    p = np_params(jmodel, seed=2, w_scale=3.0)
    out = serve.main(["--arch", arch, "--reduced", "--batch", "3", "--prompt-len", "20",
                      "--gen-len", "6", "--streams", "6", "--engine", "--quant", "4",
                      "--kv-dtype", kv_dtype, "--seed", "5", "--device", "cpu"],
                     params=params_from_numpy(p, device="cpu"))
    assert set(out["states"].values()) == {"done"}
    assert out["tokens"] == jax_engine_tokens(arch, p, kv_dtype, 5)
