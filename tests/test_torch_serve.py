"""Port parity: the serving entry point (repro_torch.launch.serve) vs the
JAX package's ``repro.launch.serve`` on the same carried params.

Greedy tokens must be identical; logits agree to 1e-4 (f32, sums in
another order). The port runs on the CPU here through ``--device cpu``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.launch import serve as jserve
from repro.models import get_model as j_get_model
from repro_torch.deploy import QuantizedArtifact
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SHAPE = ["--reduced", "--batch", "4", "--prompt-len", "16", "--gen-len", "6",
         "--no-compare-fp"]


def np_params(seed=0, w_scale=1.0):
    """Reduced brecq-lm-100m params made with numpy; ``w_scale`` scales the
    linear weights (3x keeps greedy decode from settling on one token)."""
    _, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "g":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "table":
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        lim = w_scale / np.sqrt(s.shape[-2])
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def replay_logits_jax(art_dir, toks, gen):
    """Prefill + teacher-forced decode of ``gen`` through the JAX model."""
    _, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    art = JArtifact.load(str(art_dir))
    b, s = toks.shape
    cache = jmodel.init_cache(b, s + gen.shape[1], jnp.float32)
    logits, cache = jmodel.prefill(art.params, {"tokens": jnp.asarray(toks)},
                                   cache, remat="none")
    out = [np.asarray(logits)]
    step = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    for i in range(gen.shape[1] - 1):
        logits, cache = step(art.params, jnp.asarray(gen[:, i:i + 1]), cache,
                             jnp.full((b,), s + i, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out, 1)


@torch.inference_mode()
def replay_logits_torch(art_dir, toks, gen):
    _, model = get_model("brecq_lm_100m", reduced=True)
    art = QuantizedArtifact.load(str(art_dir))
    b, s = toks.shape
    cache = model.init_cache(b, s + gen.shape[1], torch.float32)
    logits, cache = model.prefill(art.params, {"tokens": torch.from_numpy(toks)}, cache)
    out = [logits.numpy()]
    for i in range(gen.shape[1] - 1):
        logits, cache = model.decode_step(
            art.params, torch.from_numpy(gen[:, i:i + 1]), cache,
            torch.full((b,), s + i, dtype=torch.int32))
        out.append(logits.numpy())
    return np.stack(out, 1)


def prompts(batch=4, seq=16):
    from repro_torch.data import Corpus, CorpusConfig

    return Corpus(CorpusConfig(vocab=512)).sample(batch, seq, seed=7)


def test_corpus_prompts_match_jax():
    from repro.data import Corpus as JCorpus
    from repro.data import CorpusConfig as JCorpusConfig

    want = JCorpus(JCorpusConfig(vocab=512)).sample(8, 130, seed=7)
    np.testing.assert_array_equal(prompts(8, 130), want)


@pytest.mark.parametrize("bits", [4, 2])
def test_serve_quant_matches_jax(tmp_path, bits):
    p = np_params()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jgen = np.asarray(jserve.main(
        [*SHAPE, "--quant", str(bits), "--save-artifact", str(jdir)],
        params=jax.tree.map(jnp.asarray, p)))
    out = serve.main([*SHAPE, "--quant", str(bits), "--save-artifact", str(tdir),
                      "--device", "cpu"],
                     params=params_from_numpy(p, device="cpu"))
    tgen = out["tokens"].numpy()
    np.testing.assert_array_equal(tgen, jgen)  # identical greedy tokens
    assert out["stats"]["qmm_tiers"]["decode"] > 0
    assert out["stats"]["qmm_tiers"]["prefill"] > 0
    # the two CLIs shipped byte-identical artifacts
    jm, tm = JArtifact.load(str(jdir)).manifest, QuantizedArtifact.load(str(tdir)).manifest
    assert tm["checksums"] == jm["checksums"]
    assert tm["content_digest"] == jm["content_digest"]
    toks = prompts()
    np.testing.assert_allclose(replay_logits_torch(tdir, toks, tgen),
                               replay_logits_jax(jdir, toks, jgen),
                               rtol=TOL, atol=TOL)


def test_jax_exported_artifact_served_by_port(tmp_path):
    p = np_params(seed=1)
    j_rtn_artifact(jax.tree.map(jnp.asarray, p), 4, 64).save(str(tmp_path))
    jgen = np.asarray(jserve.main([*SHAPE, "--artifact", str(tmp_path)],
                                  params=jax.tree.map(jnp.asarray, p)))
    out = serve.main([*SHAPE, "--artifact", str(tmp_path), "--device", "cpu"],
                     params=params_from_numpy(p, device="cpu"))
    np.testing.assert_array_equal(out["tokens"].numpy(), jgen)


def test_serve_rejects_mismatched_artifact(tmp_path):
    from repro_torch.deploy import ArtifactMismatchError

    serve.main([*SHAPE, "--quant", "4", "--save-artifact", str(tmp_path),
                "--device", "cpu"])
    with pytest.raises(ArtifactMismatchError, match="n_layers"):
        serve.main(["--arch", "brecq_lm_100m", "--artifact", str(tmp_path),
                    "--device", "cpu"])


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300, **kw)


def test_main_cli_cpu_smoke():
    res = _run(["-m", "repro_torch.launch.serve", *SHAPE, "--quant", "2",
                "--group", "64", "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    assert "qmm tiers: decode=" in res.stdout and "packed W2 artifact" in res.stdout


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([*SHAPE, "--quant", "4"])


ENGINE = ["--reduced", "--batch", "4", "--prompt-len", "16", "--gen-len", "6",
          "--streams", "6", "--engine"]


def jax_engine_tokens(args, p, bits):
    """The JAX engine driven as the JAX CLI's ``--engine`` drives it:
    arrivals, lengths and prompts drawn from ``--seed``, an RTN artifact of
    ``p``, the worst-case pool."""
    from repro.data import Corpus as JCorpus
    from repro.data import CorpusConfig as JCorpusConfig
    from repro.serve_engine import EngineConfig, ServeEngine

    jcfg, jmodel = j_get_model("brecq_lm_100m", reduced=True)
    art = j_rtn_artifact(jax.tree.map(jnp.asarray, p), bits, None, cfg=jcfg)
    eng = ServeEngine(jmodel, art.params, EngineConfig(
        num_slots=4, page_size=16, num_pages=1 + 4 * 2, max_len=22,
        prefill_chunk=16, kv_dtype=args["kv"], overcommit=args["overcommit"],
        backend="xla"), quant=art.hook())
    n, seed = 6, args["seed"]
    rng = np.random.default_rng(seed)
    corpus = JCorpus(JCorpusConfig(vocab=jcfg.vocab))
    arrivals = sorted(int(a) for a in rng.integers(0, 4 * n, n))
    plens = rng.integers(8, 17, n)
    gens = rng.integers(3, 7, n)
    prompts = [corpus.sample(1, int(plens[i]), seed=seed + i)[0] for i in range(n)]
    nxt = 0
    while nxt < n or eng.pending():
        while nxt < n and arrivals[nxt] <= eng.tick:
            eng.submit(prompts[nxt], int(gens[nxt]))
            nxt += 1
        eng.step()
    return {u: list(r.generated) for u, r in eng.requests.items()}, eng.metrics()


@pytest.mark.parametrize("kv,overcommit", [("int8", "none"), ("float32", "prompt")])
def test_serve_engine_matches_jax_engine(kv, overcommit):
    p = np_params(seed=2, w_scale=3.0)
    out = serve.main([*ENGINE, "--quant", "4", "--kv-dtype", kv, "--overcommit",
                      overcommit, "--seed", "5", "--device", "cpu"],
                     params=params_from_numpy(p, device="cpu"))
    want, jm = jax_engine_tokens({"kv": kv, "overcommit": overcommit, "seed": 5}, p, 4)
    assert out["tokens"] == want
    assert set(out["states"].values()) == {"done"}
    m = out["metrics"]
    assert m["tokens_generated"] == jm["tokens_generated"] > 0
    assert (m["bytes_per_page"], m["ticks"]) == (jm["bytes_per_page"], jm["ticks"])
    assert out["artifact_bytes"] < out["fp_bytes"]


def test_engine_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([*ENGINE, "--quant", "4"])


def test_engine_cli_cpu_smoke():
    res = _run(["-m", "repro_torch.launch.serve", *ENGINE, "--quant", "4",
                "--device", "cpu", "--overcommit", "prompt", "--num-pages", "5"])
    assert res.returncode == 0, res.stderr
    assert "[engine int8]" in res.stdout and "tok/s sustained" in res.stdout


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, repro_torch.launch.serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_port_sources_have_no_reference_imports():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits
