"""Device time of every kernel that is not hand-written, per 1000 real
prompt tokens of the prefill waves in the profiled sub-window."""
from portbench.breakdown import glue_s


def read(run):
    spent, calls = glue_s(run)
    tokens = sum(sum(b.lens) for b in calls)
    return 1e3 * spent / (tokens / 1000.0) if tokens else None
