"""The model's matmul and attention operations (portbench/counts.py) of
the window's engine calls before the profiled sub-window, over their
host-clock time (each ends in a synchronise) at the int8 dense peak."""
from portbench.breakdown import driver, window
from portbench.counts import PEAK_INT8_OPS


def read(run):
    w = window(run)
    cut = w[0] if w else run.window_s
    calls = [b for b in run.batches if b.t0 >= 0 and b.t1 <= cut]
    spent = sum(b.t1 - b.t0 for b in calls)
    if not spent:
        return None
    ops = sum(driver(run).model_ops(run, b) for b in calls)
    return 100.0 * ops / (spent * PEAK_INT8_OPS)
