"""Share of its roofline bound that ``fused_ffn`` reaches in the profiled
sub-window (portbench/counts.py's bound over the kernel's device time)."""
from portbench.breakdown import roofline


def read(run):
    return roofline(run, "fused_ffn_kernel")
