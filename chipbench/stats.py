"""Window arithmetic: rates over all the work and all the time, and tails
of all requests."""
from __future__ import annotations

import math


def rate(amount: float, start: float, ends: list) -> float | None:
    """``amount`` over the time from ``start`` to the last completion:
    every unit of work of the window and every second of it, stalls
    included."""
    if not ends:
        return None
    span = max(ends) - start
    return amount / span if span > 0 else None


def percentile(values, q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` percent of the values at or below it."""
    vals = sorted(values)
    if not vals:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]

