"""Padded over all prompt-token slots of the window's prefill waves
(left padding to the prompt bucket and empty rows of the batch bucket)."""


def read(run):
    s = run.stats
    return 100.0 * (1.0 - s["tokens"] / s["slots"]) if s.get("slots") else None
