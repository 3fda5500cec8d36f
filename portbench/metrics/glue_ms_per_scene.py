"""Device time of every kernel that is not one of the port's hand-written
kernels (the VersaQ glue and the model's PyTorch operators), per real
scene of the forwards in the profiled sub-window."""
from portbench.breakdown import glue_s


def read(run):
    spent, calls = glue_s(run)
    scenes = sum(b.real for b in calls)
    return 1e3 * spent / scenes if scenes else None
