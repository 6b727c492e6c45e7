"""Percentiles as every metric here takes them: linear interpolation
between order statistics (numpy's default)."""
from __future__ import annotations

import numpy as np


def pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else float("nan")
