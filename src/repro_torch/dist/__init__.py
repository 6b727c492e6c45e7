"""Distribution plane of the port.

``sharding`` holds the mesh sharding :class:`Plan` (JAX's rules, spec for
spec, turned into DTensor placements), :func:`pick_strategy` and
:func:`estimate_params` (the exact parameter count of a config). The step
builders that run under a plan are in ``launch/steps.py``; the int8
error-feedback all-reduce is ``optim/grad_compress.py``.
"""
from .sharding import (STRATEGIES, Plan, estimate_params,  # noqa: F401
                       pick_strategy, placements)
