"""Traffic generation from a mix file and a seed.

Every seed gets the same multiset of sizes and gaps in another order, so
the seed changes which request comes when, not how much work a window
holds: inter-arrival gaps are the exponential distribution's quantiles at
(i + 0.5) / n in one fixed order that the seed rotates, and prompt
lengths the log-normal's quantiles, shuffled by the seed in blocks.
Request contents (patch embeddings, token ids) are drawn per request from
``sub_seed(seed, kind, index)``."""
from __future__ import annotations

import math
import statistics

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(v) % 2**64 for v in (seed, *path)])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


# The one order of the open loop's gaps: drawn once from this constant and
# never from the run's seed.  A seed-drawn order moved the bursts, and with
# them the p95, by 10-12% from seed to seed while two runs of one seed
# agreed within 2%; one order turned by the seed keeps every seed's bursts.
GAP_ORDER_SEED = 1


def open_loop_times(rate_per_s: float, window_s: float, seed: int) -> list[float]:
    """Arrival offsets in (0, window_s) of an open loop with exponential
    gaps at ``rate_per_s``: round(rate * window) arrivals whose gaps are
    the exponential's quantiles, in the fixed order ``GAP_ORDER_SEED``
    gives, turned by a seed-drawn rotation, scaled to the window.  Every
    seed so sends the same arrivals and bursts, from another starting
    point; the tail then follows the system, not the seed's luck."""
    n = max(1, round(rate_per_s * window_s))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps = np.roll(rng(GAP_ORDER_SEED, 1).permutation(gaps), int(rng(seed, 1).integers(n)))
    t = np.cumsum(gaps)
    t = t * window_s / (t[-1] + float(np.mean(gaps)))
    return [float(x) for x in t]


def lengths(spec: dict, n: int, seed: int, block: int = 64) -> list[int]:
    """``n`` lengths from a distribution spec ``{"dist": "lognormal",
    "median", "sigma", "min", "max"}``: consecutive blocks of ``block``, each the distribution's quantiles at
    (i + 0.5) / block, clipped, in its own seed-drawn order, so any run of
    consecutive requests holds nearly the same multiset whatever the seed."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = statistics.NormalDist(math.log(spec["median"]), spec["sigma"])
    q = [min(max(round(math.exp(nd.inv_cdf((i + 0.5) / block))), spec["min"]), spec["max"])
         for i in range(block)]
    g = rng(seed, 2)
    out = []
    while len(out) < n:
        out += [int(q[i]) for i in g.permutation(block)]
    return out[:n]
