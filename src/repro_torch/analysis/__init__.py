"""Analysis of the port: whole-step roofline bounds on the H100
(:mod:`.roofline`) and the static audits (:mod:`.audit`)."""
from .roofline import (Roofline, active_params, from_hlo,  # noqa: F401
                       ideal_serve_bytes, model_flops)
