"""Share of the window's micro-batch releases (the program's ``flush``
events) whose reason is ``deadline``: a group released because its oldest
request waited ``max_wait_s``, not because it filled."""


def read(run):
    reasons = [ev["reason"] for ev in run.events
               if ev["phase"] == "flush" and 0.0 <= ev["t"] < run.window_s]
    return 100.0 * reasons.count("deadline") / len(reasons) if reasons else None
