"""Order statistics of the window's samples."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest sample with at
    least q percent of the samples at or below it."""
    if not values:
        raise ValueError("no samples")
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
