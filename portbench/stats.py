"""The benchmark's arithmetic on a window: rates, times per fit and
percentiles, each over all the work and all the time of the window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks, numpy's default; NaN for no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)


def rate(units: float, seconds: float) -> float:
    """Units completed per second of the whole window."""
    return units / seconds if seconds > 0 else math.nan


def per_item(seconds: float, items: int) -> float:
    """The whole window's seconds per item completed in it."""
    return seconds / items if items else math.nan
