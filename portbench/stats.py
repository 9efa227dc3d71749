"""Statistics the metric readers share."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value that at least ``q`` percent of them do not exceed."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
