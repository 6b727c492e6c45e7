"""Distribution plane of the port.

Holds :func:`estimate_params` (the exact parameter count of a config) for
now; the mesh sharding ``Plan`` of the JAX package's ``repro.dist`` is not
ported yet.
"""
from .sharding import estimate_params  # noqa: F401
