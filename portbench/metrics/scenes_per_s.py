"""Scenes served in the window over the window's seconds: each engine
call's real scenes, counted by the share of its host span that lies in
the window (so the call running at the close counts in part)."""


def read(run):
    T = run.window_s
    if not run.batches:
        return None
    work = 0.0
    for b in run.batches:
        inside = max(0.0, min(b.t1, T) - max(b.t0, 0.0))
        work += b.real * inside / (b.t1 - b.t0)
    return work / T
