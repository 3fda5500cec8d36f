"""Percentiles and spreads as the benchmark defines them.

A request that failed, was refused, or never completed counts as missing:
its latency is infinite, so it sits at the top of every tail."""
from __future__ import annotations

import math

INF = math.inf
# JSON has no infinity: an infinite tail (more than 5% of the requests
# missing) is printed as this many milliseconds
MISSING_MS = 1e12


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (the smallest value with at least q% of the
    values at or below it); ``inf`` entries count as missing requests."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def finite_ms(seconds: float) -> float:
    return MISSING_MS if math.isinf(seconds) else seconds * 1e3

