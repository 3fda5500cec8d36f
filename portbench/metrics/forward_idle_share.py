"""Share of the host intervals of the ``model`` spans of the prefill
calls in the profiled sub-window in which no device activity ran (the
device trace on the spans' clock, ``_spans.placed``): the part of a
wave's forward the host's launches leave the device idle."""
from portbench.metrics import _spans


def read(run):
    busy = length = 0.0
    for p in _spans.placed(run)[0].values():
        b, n = _spans.busy_share(p, [_spans.host(_spans.model(p.kids))])
        busy, length = busy + b, length + n
    return 100.0 * (length - busy) / length if length else None
