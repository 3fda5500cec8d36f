"""95th percentile of an LM request's time from ``submit`` to its first
token (the result of a one-token request)."""
from portbench.metrics._tails import tail_ms


def read(run):
    return tail_ms(run, 95)
