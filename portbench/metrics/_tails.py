"""Shared arithmetic of the end-to-end readers."""
from portbench.stats import INF, finite_ms, percentile


def tail_ms(run, q: float) -> float | None:
    """q-th percentile of (done - owed) over every request owed service in
    the window; a failed or undelivered request is infinitely late."""
    lat = [(r.done - r.start) if r.ok else INF for r in run.in_window()]
    return finite_ms(percentile(lat, q)) if lat else None
