"""Port parity: RTN packing, checksums and the artifact format
(repro_torch.deploy) vs the JAX package.

Packed codes, qscale, checksums and the content digest must be
byte-identical: the JAX artifact's scales come from the jitted
``quantize_tree``, where XLA turns ``amax / qmax`` into a multiply by the
f32 reciprocal, and the port computes them the same way. Artifacts saved
by either package must load verified in the other.
"""
import faults
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import QuantizedArtifact as JArtifact
from repro.deploy import pack as jpack
from repro.deploy import rtn_artifact as j_rtn_artifact
from repro.models import get_model as j_get_model
from repro_torch.deploy import (ArtifactCorruptionError, ArtifactSchemaError,
                                QuantizedArtifact, pack, rtn_artifact)
from repro_torch.interop import flatten_paths, params_from_numpy, params_to_numpy
from repro_torch.models import get_config


def np_params(arch="brecq_lm_100m", seed=0):
    """Reduced-size params tree made with numpy, in the JAX layout."""
    _, model = j_get_model(arch, reduced=True)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "g":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "table":
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        lim = 1.0 / np.sqrt(s.shape[-2])
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


def torch_flat(tree):
    return {k: v.numpy() for k, v in flatten_paths(tree).items()}


def assert_trees_identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("bits,group", [(4, None), (4, 64), (2, None), (2, 64)])
def test_quantize_tree_matches_jitted_jax(bits, group):
    p = np_params()
    want = jax.jit(jpack.quantize_tree, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), bits, group)
    got = pack.quantize_tree(params_from_numpy(p, device="cpu"), bits, group)
    assert_trees_identical(torch_flat(got), jax_flat(want))


@pytest.mark.parametrize("bits,group", [(4, None), (4, 64), (2, None), (2, 64)])
def test_rtn_artifact_matches_jax(bits, group):
    p = np_params()
    cfg = get_config("brecq_lm_100m", reduced=True)
    j = j_rtn_artifact(jax.tree.map(jnp.asarray, p), bits, group, cfg=cfg)
    t = rtn_artifact(params_from_numpy(p, device="cpu"), bits, group, cfg=cfg)
    assert_trees_identical(torch_flat(t.params), jax_flat(j.params))
    for key in ("bits_by_path", "w_group", "arch", "n_layers", "d_model", "vocab"):
        assert t.manifest[key] == j.manifest[key], key
    assert t.nbytes() == j.nbytes()
    assert t.stats["bits_histogram"] == j.stats["bits_histogram"]


@pytest.mark.parametrize("bits", [4, 2])
def test_full_width_leaf_scales_match_jit(bits):
    """One full-width brecq-lm-100m leaf (w_gate, 768x2048): qscale is
    bit-identical to the jitted JAX pack (the jit reciprocal)."""
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((768, 2048)) * 0.03).astype(np.float32)
    tree = {"mlp": {"w_gate": {"w": w}}}
    want = jax.jit(jpack.quantize_tree, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, tree), bits, None)
    got = pack.quantize_tree(params_from_numpy(tree, device="cpu"), bits, None)
    assert_trees_identical(torch_flat(got), jax_flat(want))


def test_checksums_and_digest_match_jax():
    p = np_params()
    j = jax.jit(jpack.quantize_tree, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), 4, 64)
    t = pack.quantize_tree(params_from_numpy(p, device="cpu"), 4, 64)
    jc, tc = jpack.tree_checksums(j), pack.tree_checksums(t)
    assert tc == jc
    assert pack.content_digest(tc) == jpack.content_digest(jc)
    assert pack.tree_bytes(t) == jpack.tree_bytes(j)


@pytest.mark.parametrize("bits", [4, 2])
def test_jax_saved_artifact_loads_verified_in_torch(tmp_path, bits):
    p = np_params()
    j = j_rtn_artifact(jax.tree.map(jnp.asarray, p), bits, None)
    j.save(str(tmp_path))
    t = QuantizedArtifact.load(str(tmp_path), verify=True)
    assert_trees_identical(torch_flat(t.params), jax_flat(j.params))
    assert t.manifest["content_digest"] == j.manifest["content_digest"]


@pytest.mark.parametrize("bits", [4, 2])
def test_torch_saved_artifact_loads_verified_in_jax(tmp_path, bits):
    p = np_params()
    t = rtn_artifact(params_from_numpy(p, device="cpu"), bits, 64)
    t.save(str(tmp_path))
    j = JArtifact.load(str(tmp_path), verify=True)
    assert_trees_identical(jax_flat(j.params), torch_flat(t.params))
    assert j.manifest["checksums"] == t.manifest["checksums"]


def test_flipped_bit_raises_corruption_naming_leaf(tmp_path):
    t = rtn_artifact(params_from_numpy(np_params(), device="cpu"), 4, None)
    t.save(str(tmp_path))
    leaf = next(k for k in t.manifest["checksums"] if k.endswith("wq/w"))
    faults.flip_leaf_bit(str(tmp_path), leaf, byte_index=7, bit=3)
    with pytest.raises(ArtifactCorruptionError) as e:
        QuantizedArtifact.load(str(tmp_path))
    assert e.value.leaf == leaf
    # the escape hatch loads the damaged bytes unchecked
    lax = QuantizedArtifact.load(str(tmp_path), verify=False)
    assert lax.params["body"]["sub0"]["attn"]["wq"]["w"].dtype == torch.int8


def test_checksum_mismatch_names_leaf(tmp_path):
    t = rtn_artifact(params_from_numpy(np_params(), device="cpu"), 2, None)
    t.save(str(tmp_path))
    leaf = next(k for k in t.manifest["checksums"] if k.endswith("w_up/qscale"))
    faults.edit_manifest(str(tmp_path), lambda m: m["manifest"]["checksums"]
                         .__setitem__(leaf, 12345))
    with pytest.raises(ArtifactCorruptionError) as e:
        QuantizedArtifact.load(str(tmp_path))
    assert e.value.leaf == leaf


def test_missing_schema_raises(tmp_path):
    t = rtn_artifact(params_from_numpy(np_params(), device="cpu"), 4, None)
    t.save(str(tmp_path))
    faults.edit_manifest(str(tmp_path),
                         lambda m: m["manifest"].pop("schema_version"))
    with pytest.raises(ArtifactSchemaError, match="no manifest schema_version"):
        QuantizedArtifact.load(str(tmp_path))
    assert QuantizedArtifact.load(str(tmp_path), verify=False).params


def test_hook_needs_serve_hook_for_act_scales():
    t = rtn_artifact(params_from_numpy(np_params(), device="cpu"), 4, None)
    from repro_torch.models.common import NO_QUANT

    assert t.hook() is NO_QUANT
    t.act_scales = {"body/sub0/attn/wq": torch.ones(())}
    t.manifest["a_bits"] = 8
    hook = t.hook()  # the LSQ ServeHook, as the JAX package serves it
    from repro_torch.core.hooks import ServeHook

    assert isinstance(hook, ServeHook) and hook.a_bits == 8
    assert hook.act_scales is t.act_scales


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """No device means CUDA: without a card it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.ones((2, 2), np.float32)})


def test_interop_roundtrip_keeps_dtypes():
    tree = {"a": {"w": np.arange(6, dtype=np.int8).reshape(2, 3)},
            "b": np.ones(4, np.float32), "c": np.arange(3, dtype=np.int32)}
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert back["a"]["w"].dtype == np.int8 and back["b"].dtype == np.float32
    assert back["c"].dtype == np.int32
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])


@pytest.mark.parametrize("bits,k,groups", [(4, 64, 1), (2, 64, 4), (8, 64, 2),
                                           (4, 62, 1), (2, 66, 1)])
def test_pack_codes_and_dequant_leaf_match_jax(bits, k, groups):
    """Stacked (L, K, N) leaves; K=62/66 do not divide the packing factor,
    so the codes are promoted to an int8 container, unchanged in value."""
    rng = np.random.default_rng(k + bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rng.integers(lo, hi + 1, size=(3, k, 10)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(3, groups, 10)).astype(np.float32)
    assert pack.container_bits(bits, k) == jpack.container_bits(bits, k)
    want = np.asarray(jpack.pack_codes(jnp.asarray(codes), k, bits))
    got = pack.pack_codes(torch.from_numpy(codes), k, bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pack.code_layout(got, k) == jpack.code_layout(jnp.asarray(want), k)
    np.testing.assert_array_equal(
        pack.dequant_leaf(got, torch.from_numpy(scales), k).numpy(),
        np.asarray(jpack.dequant_leaf(jnp.asarray(want), jnp.asarray(scales), k)))


def test_code_layout_rejects_bad_row_counts():
    with pytest.raises(ValueError, match="do not divide"):
        pack.code_layout(torch.zeros((3, 4), dtype=torch.int8), 10)
    with pytest.raises(ValueError, match="values/byte"):
        pack.code_layout(torch.zeros((2, 4), dtype=torch.int8), 16)
