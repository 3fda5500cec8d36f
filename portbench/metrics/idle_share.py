"""Share of the profiled sub-window, while some request was outstanding,
in which no kernel ran on the device (from the union of kernel intervals)."""
from portbench.breakdown import kernels_in, outstanding, overlap, window
from portbench.devtrace import gaps


def read(run):
    w = window(run)
    ks = kernels_in(run)
    if w is None or not ks:
        return None
    owed = [(max(a, w[0]), min(b, w[1])) for a, b in outstanding(run) if b > w[0] and a < w[1]]
    owed_s = sum(b - a for a, b in owed)
    if owed_s <= 0:
        return None
    idle = sum(overlap(g, owed) for g in gaps([(t0, t1) for _, t0, t1 in ks], w[0], w[1]))
    return 100.0 * idle / owed_s
