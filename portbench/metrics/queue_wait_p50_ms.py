"""Median wait from a request's due (open loop) or submit (closed loop)
time to its ``admit`` span event, over the requests owed before the
profiled sub-window."""
from portbench.breakdown import window
from portbench.stats import percentile


def read(run):
    admit = {}
    for ev in run.events:
        if ev["phase"] == "admit" and ev.get("request") not in admit:
            admit[ev.get("request")] = ev["t"]
    w = window(run)
    cut = w[0] if w else run.window_s
    waits = [admit[r.req_id] - r.start for r in run.requests
             if r.req_id in admit and r.start is not None and r.start < cut]
    return percentile(waits, 50) * 1e3 if waits else None
