"""Analysis of the port: whole-step roofline bounds on the H100
(:mod:`.roofline`), one eager step's FLOPs, bytes and collective bytes
(:mod:`.optrace`, the counterpart of the reference's ``analysis/hlo.py``)
and the static audits (:mod:`.audit`)."""
from .roofline import (Roofline, active_params, from_hlo, from_step,  # noqa: F401
                       ideal_serve_bytes, model_flops)
