"""95th percentile of a scene request's latency, from its due time on the
open-loop schedule to ``AsyncServer.result`` returning."""
from portbench.metrics._tails import tail_ms


def read(run):
    return tail_ms(run, 95)
