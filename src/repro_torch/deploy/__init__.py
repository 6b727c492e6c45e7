"""Packed-int deployment: the artifact format shared with the JAX package.

  * :class:`QuantizedArtifact` — packed codes + scales + manifest, with
    verified save/load (schema v2 checksums).
  * :func:`export` — a calibrated ``PTQResult`` -> artifact.
  * :func:`rtn_artifact` / :func:`quantize_tree` — calibration-free RTN.
  * Integrity helpers and the typed load errors.
  * :mod:`.budget` — budgeted mixed precision: :func:`solve_budget` over
    measured/bytes cost tables, :func:`budget_artifact` (budget in,
    servable artifact out), measured qmm dispatch.
"""
from .artifact import (ARTIFACT_SCHEMA_VERSION,  # noqa: F401
                       ArtifactCorruptionError, ArtifactError,
                       ArtifactMismatchError, ArtifactSchemaError,
                       QuantizedArtifact, export, rtn_artifact)
from .budget import (budget_artifact, rtn_mixed_artifact,  # noqa: F401
                     solve_budget)
from .pack import (code_layout, container_bits, content_digest,  # noqa: F401
                   dequant_leaf, leaf_crc32, pack_codes, quantize_tree,
                   rtn_bits_by_path, rtn_codes, rtn_pack_leaf, tree_bytes,
                   tree_checksums)
