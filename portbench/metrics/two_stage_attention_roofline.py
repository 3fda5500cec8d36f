"""Share of its roofline bound that ``two_stage_attention`` reaches in the
profiled sub-window (bound by exponentials at these lengths)."""
from portbench.breakdown import roofline


def read(run):
    return roofline(run, "two_stage_attention_kernel")
