"""End-to-end arithmetic: rates over a window and tails of all samples."""

from __future__ import annotations

import math


def rate(units: float, window_s: float) -> float:
    """Work over all of the window's seconds."""
    return units / window_s


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
