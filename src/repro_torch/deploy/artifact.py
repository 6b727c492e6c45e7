"""`QuantizedArtifact`: the packed deployment artifact.

Same object and on-disk format as the JAX package's
``repro.deploy.artifact``: packed ``params`` (nodes ``{"w": int8 codes,
"qscale": f32}``), ``act_scales``, a JSON ``manifest`` and ``stats``,
saved through the checkpoint layer with schema version 2 (per-leaf
crc32 + content digest, verified on load). An artifact written by either
package loads verified in the other.

Export is exact: baked fake-quant weights in ``PTQResult.params_q`` lie
on the quantizer grid, so ``quantize_int`` recovers the integer codes
bit-perfectly and ``dequant(pack(codes)) == params_q`` leaf for leaf.
Artifacts calibrated with activation scales serve through the LSQ
``ServeHook`` (:meth:`QuantizedArtifact.hook`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from ..ckpt.checkpoint import CheckpointManager, CheckpointReadError
from ..core.quantizer import quantize_int
from ..interop import tree_map
from .pack import (content_digest, pack_codes, quantize_tree,
                   rtn_bits_by_path, tree_bytes, tree_checksums)

Params = Any

ARTIFACT_VERSION = 1
# Manifest schema: v2 carries per-leaf crc32 checksums + content digest.
ARTIFACT_SCHEMA_VERSION = 2
_ESC = "%2F"  # act-scale paths contain '/', which is the ckpt tree separator


class ArtifactError(RuntimeError):
    """Base for deployment-artifact failures (load/verify/serve)."""


class ArtifactSchemaError(ArtifactError):
    """The artifact's manifest schema is missing, older, or newer than
    this build understands."""


class ArtifactCorruptionError(ArtifactError):
    """The artifact's stored bytes do not match its manifest checksums.
    Names the offending leaf when one can be identified."""

    def __init__(self, message: str, leaf: Optional[str] = None):
        super().__init__(message)
        self.leaf = leaf


class ArtifactMismatchError(ArtifactError):
    """A structurally valid artifact does not match the model it is
    being served with (arch/dims disagree, or packing did not shrink)."""


@dataclasses.dataclass
class QuantizedArtifact:
    """Packed-int deployment artifact. See module docstring."""

    params: Params
    act_scales: dict[str, torch.Tensor]
    manifest: dict
    stats: dict = dataclasses.field(default_factory=dict)

    def nbytes(self) -> int:
        return tree_bytes(self.params) + tree_bytes(self.act_scales)

    @property
    def a_bits(self) -> Optional[int]:
        return self.manifest.get("a_bits")

    def to(self, device) -> "QuantizedArtifact":
        """The same artifact with every tensor on ``device``."""
        move = lambda t: t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, params=tree_map(move, self.params),
            act_scales={k: move(v) for k, v in self.act_scales.items()})

    def hook(self):
        """Serving hook: the default weight-provider (packed matmuls via
        ``qmm``), plus LSQ activation fake-quant (``ServeHook``) when the
        artifact was calibrated with activation scales."""
        from ..models.common import NO_QUANT

        if self.act_scales and self.a_bits:
            from ..core.hooks import ServeHook

            return ServeHook(self.act_scales, self.a_bits)
        return NO_QUANT

    def save(self, directory: str, step: int = 0) -> None:
        """Atomic save through the checkpoint layer (npz + manifest),
        stamping ``schema_version``, per-leaf ``checksums`` and the
        ``content_digest`` that :meth:`load` verifies."""
        mgr = CheckpointManager(directory, keep=1)
        tree = {"params": self.params,
                "act_scales": {k.replace("/", _ESC): v
                               for k, v in self.act_scales.items()}}
        checksums = tree_checksums(tree)
        self.manifest["schema_version"] = ARTIFACT_SCHEMA_VERSION
        self.manifest["checksums"] = checksums
        self.manifest["content_digest"] = content_digest(checksums)
        mgr.save(step, tree, meta={"manifest": self.manifest,
                                   "stats": self.stats})

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, *,
             verify: bool = True) -> "QuantizedArtifact":
        """Load a saved artifact (CPU tensors), verifying by default: the
        schema version must match, every leaf must hash to its manifest
        crc32 and the leaf set must match the ``content_digest``.
        ``verify=False`` loads whatever bytes are on disk."""
        mgr = CheckpointManager(directory)
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no artifact checkpoint in {directory}")
        meta = mgr.manifest(step)["meta"]
        manifest = meta.get("manifest", {})
        if verify:
            _check_schema(manifest, directory)
        try:
            tree = mgr.restore_nested(step, strict=verify)
        except CheckpointReadError as e:
            if e.member is not None:
                raise ArtifactCorruptionError(
                    f"artifact {directory} step {step}: leaf {e.member!r} "
                    f"is truncated or bit-flipped on disk: {e}",
                    leaf=e.member) from e
            raise ArtifactCorruptionError(
                f"artifact {directory} step {step} is unreadable "
                f"(truncated or corrupt): {e}") from e
        if verify:
            _verify_checksums(tree, manifest, directory)
        acts = {k.replace(_ESC, "/"): v
                for k, v in tree.get("act_scales", {}).items()}
        return cls(params=tree["params"], act_scales=acts,
                   manifest=manifest, stats=meta.get("stats", {}))


def _check_schema(manifest: dict, directory: str) -> None:
    schema = manifest.get("schema_version")
    if schema is None:
        raise ArtifactSchemaError(
            f"artifact {directory} has no manifest schema_version (pre-v2 "
            f"artifact, saved without integrity checksums). Re-export and "
            f"save it with this build to upgrade, or pass verify=False "
            f"(serve: --no-verify) to load it unchecked.")
    if schema != ARTIFACT_SCHEMA_VERSION:
        raise ArtifactSchemaError(
            f"artifact {directory} has manifest schema_version={schema} but "
            f"this build reads schema_version={ARTIFACT_SCHEMA_VERSION}. "
            f"Re-export the artifact with this build, or pass verify=False "
            f"(serve: --no-verify) to load it unchecked.")


def _verify_checksums(tree, manifest: dict, directory: str) -> None:
    want: dict = manifest.get("checksums") or {}
    if not want:
        raise ArtifactSchemaError(
            f"artifact {directory} declares schema_version="
            f"{manifest.get('schema_version')} but carries no checksums — "
            f"manifest is corrupt or hand-edited; pass verify=False to "
            f"load it unchecked.")
    got = tree_checksums(tree)
    for key in sorted(want):
        if key not in got:
            raise ArtifactCorruptionError(
                f"artifact {directory}: leaf {key!r} listed in the manifest "
                f"is missing from arrays.npz", leaf=key)
    for key in sorted(got):
        if key not in want:
            raise ArtifactCorruptionError(
                f"artifact {directory}: stored leaf {key!r} is not listed "
                f"in the manifest checksums", leaf=key)
        if int(want[key]) != got[key]:
            raise ArtifactCorruptionError(
                f"artifact {directory}: checksum mismatch at leaf {key!r} "
                f"(manifest crc32={int(want[key])}, stored bytes crc32="
                f"{got[key]}) — the leaf was truncated or bit-flipped on "
                f"disk", leaf=key)
    digest = content_digest({k: int(v) for k, v in want.items()})
    if manifest.get("content_digest") != digest:
        raise ArtifactCorruptionError(
            f"artifact {directory}: manifest content_digest does not match "
            f"its own checksum table — the manifest was edited")


# ---------------------------------------------------------------------------
# export: PTQResult -> artifact
# ---------------------------------------------------------------------------


def export(model, result, *, a_bits: Optional[int] = None,
           kv_dtype: str = "int8", kv_page_size: int = 16) -> QuantizedArtifact:
    """Pack a calibrated :class:`repro_torch.core.PTQResult` into a
    :class:`QuantizedArtifact` (on the result's device).

    Args:
      model: the model the result was calibrated for (its config feeds the
        manifest).
      result: ``PTQResult`` from :func:`repro_torch.core.quantize`: the
        hardened weights in ``params_q``, per-path (QState, QConfig) in
        ``qstates`` (incl. mixed-precision widths and the 8-bit embed/head).
      a_bits: activation bit-width matching ``result.act_scales``; taken
        from ``result.stats`` when calibration recorded it.
      kv_dtype / kv_page_size: serving-side KV cache policy recorded in
        the manifest.

    Returns:
      Artifact whose dequantized weights equal ``result.params_q``
      bit for bit.
    """
    t0 = time.time()
    if a_bits is None:
        a_bits = result.stats.get("a_bits") if isinstance(result.stats, dict) else None
    params_q = result.params_q
    art = tree_map(lambda x: x, params_q)  # fresh containers, shared leaves
    bits_by_path: dict[str, int] = {}
    group = None

    # group stacked per-layer paths ("body.3/sub0/attn/wq") by their leaf
    stacked: dict[tuple, dict[int, str]] = {}
    flat: list[str] = []
    for path, (st, qc) in result.qstates.items():
        bits_by_path[path] = qc.bits
        if qc.group_size is not None:
            group = qc.group_size
        parts = path.split("/")
        if "." in parts[0]:
            sname, ri = parts[0].rsplit(".", 1)
            stacked.setdefault((sname, *parts[1:]), {})[int(ri)] = path
        else:
            flat.append(path)

    for key, by_layer in stacked.items():
        node = art[key[0]]
        for k in key[1:]:
            node = node[k]
        w = node["w"]  # (n_layers, ..., K, N) baked fake-quant values
        n = w.shape[0]
        missing = set(range(n)) - set(by_layer)
        if missing:
            raise ValueError(f"unquantized layers {sorted(missing)} in "
                             f"stacked leaf {'/'.join(key)}")
        cbits = max(result.qstates[by_layer[i]][1].bits for i in range(n))
        codes, scales = [], []
        for i in range(n):
            st, qc = result.qstates[by_layer[i]]
            codes.append(quantize_int(w[i], st, qc))  # exact on-grid recovery
            scales.append(_scale_rows(st.scale, w[i].ndim))
        node["w"] = pack_codes(torch.stack(codes), w.shape[-2], cbits)
        node["qscale"] = torch.stack(scales)

    for path in flat:
        st, qc = result.qstates[path]
        if path == "embed/table":
            table = params_q["embed"]["table"]
            art["embed"]["table"] = quantize_int(table, st, qc)
            art["embed"]["table_qscale"] = st.scale.reshape(1, table.shape[-1])
        elif path == "head/w":
            w = params_q["head"]["w"]
            art["head"]["w"] = pack_codes(quantize_int(w, st, qc),
                                          w.shape[-2], qc.bits)
            art["head"]["qscale"] = _scale_rows(st.scale, w.ndim)
        else:
            raise ValueError(f"unstacked quantized path {path!r}")

    cfg = model.cfg
    manifest = {
        "version": ARTIFACT_VERSION,
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "arch": cfg.name, "family": cfg.family,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
        "tie_embeddings": cfg.tie_embeddings,
        "w_group": group, "a_bits": a_bits,
        "kv_dtype": kv_dtype, "kv_page_size": kv_page_size,
        "bits_by_path": bits_by_path,
    }
    artifact = QuantizedArtifact(art, dict(result.act_scales), manifest)
    artifact.stats = _deploy_stats(artifact, tree_bytes(params_q),
                                   time.time() - t0, bits_by_path)
    return artifact


def _scale_rows(scale: torch.Tensor, w_ndim: int) -> torch.Tensor:
    """QState scale (keepdims layout) -> the node's (..., G, N) qscale."""
    if scale.ndim == w_ndim + 1:  # grouped: (..., G, 1, N)
        return scale.squeeze(-2)
    return scale  # per-channel/tensor keepdims already (..., 1, N)-like


def rtn_artifact(params: Params, bits: int, group: Optional[int] = None,
                 *, cfg=None, kv_dtype: str = "int8",
                 kv_page_size: int = 16) -> QuantizedArtifact:
    """Calibration-free artifact: :func:`quantize_tree` + manifest/stats.
    Packing runs on whatever device ``params`` live on."""
    t0 = time.time()
    bits_by_path = rtn_bits_by_path(params, bits)
    packed = quantize_tree(params, bits, group)
    manifest = {
        "version": ARTIFACT_VERSION,
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "arch": getattr(cfg, "name", None), "family": getattr(cfg, "family", None),
        "n_layers": getattr(cfg, "n_layers", None),
        "d_model": getattr(cfg, "d_model", None),
        "vocab": getattr(cfg, "vocab", None),
        "tie_embeddings": getattr(cfg, "tie_embeddings", None),
        "w_group": group, "a_bits": None,
        "kv_dtype": kv_dtype, "kv_page_size": kv_page_size,
        "bits_by_path": bits_by_path,
    }
    artifact = QuantizedArtifact(packed, {}, manifest)
    artifact.stats = _deploy_stats(artifact, tree_bytes(params),
                                   time.time() - t0, bits_by_path)
    return artifact


def _deploy_stats(artifact: QuantizedArtifact, fp_bytes: int, wall_s: float,
                  bits_by_path: dict[str, int]) -> dict:
    hist: dict[str, int] = {}
    for b in bits_by_path.values():
        hist[str(b)] = hist.get(str(b), 0) + 1
    return {"pack_wall_s": wall_s, "artifact_bytes": artifact.nbytes(),
            "fp_bytes": fp_bytes, "bits_histogram": hist}
