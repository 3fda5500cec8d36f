"""Real scenes over batch slots of the window's forwards
(``VGGTEngine.stats``: items / (items + padded_items))."""


def read(run):
    s = run.stats
    slots = s.get("items", 0) + s.get("padded_items", 0)
    return 100.0 * s["items"] / slots if slots else None
