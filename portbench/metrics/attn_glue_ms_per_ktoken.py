"""Device time of the kernels that are not hand-written and start inside
an attention mixer part's device interval (the ``mixer`` parts of kind
``attn`` of the ``model`` span of each ``prefill.call`` in the profiled
sub-window), per 1000 real prompt tokens.  Notes the run's idle and glue
by span and part (``_spans.note``)."""
from portbench.metrics import _spans


def read(run):
    text = _spans.note(run)
    if text:
        run.notes.append(text)
    got = _spans.part_glue(run, _spans.is_attention)
    if got is None:
        return None
    spent, calls = got
    tokens = sum(c["tokens"] for c in calls)
    return 1e3 * spent / (tokens / 1000.0) if tokens else None
