"""Device time of the kernels that are not hand-written and start inside
an attention part's device interval (the ``attn`` parts of the ``model``
span of each ``vggt.call`` in the profiled sub-window), per real scene.
Notes the run's idle and glue by span and part (``_spans.note``)."""
from portbench.metrics import _spans


def read(run):
    text = _spans.note(run)
    if text:
        run.notes.append(text)
    got = _spans.part_glue(run, _spans.is_attention)
    if got is None:
        return None
    spent, calls = got
    scenes = sum(c["scenes"] for c in calls)
    return 1e3 * spent / scenes if scenes else None
