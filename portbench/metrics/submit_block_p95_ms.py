"""p95 of the program's ``submit`` span (``AsyncServer.submit``: the wait
for the engine lock and any engine call the submit ran in its caller's
thread), over the submits that began before the profiled sub-window."""
from portbench.breakdown import window
from portbench.stats import percentile


def read(run):
    w = window(run)
    cut = w[0] if w else run.window_s
    spans = [ev["dur_s"] for ev in run.events
             if ev["phase"] == "submit" and 0.0 <= ev["t"] - ev["dur_s"] < cut]
    return percentile(spans, 95) * 1e3 if spans else None
