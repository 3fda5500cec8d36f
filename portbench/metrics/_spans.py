"""What the program's own spans say (``repro_torch.obs.trace``): engine
call spans with their children, model parts with device intervals, and
the kernels of the profiled sub-window inside them, once each call's
device trace is put on the spans' clock by a two-point fit (``fit``).

The profiler's timeline and the spans' clock differ by up to a few
milliseconds and drift apart by up to a few hundred microseconds a second
(``PERF.md``).  Every engine call ends with a readback that waits for a
copy to the host; the stream reaches the end of the readback span's
device interval soon after that copy ends (25-80 us on an H100).  Those
two ends, of the call and of the call before it, fix the line from the
one clock to the other.

A call is left out, and the note counts it, when its readback's copy is
not in the trace; when more than ``MISFIT`` of its span edges fall deep
inside activities (the drift changed inside the call, which a line
misses; a CUDA event runs between two activities of its stream); or when
its ``model`` span does not hold the hand-written launches the counter
expects (the profiler lost some of its activities).  A run of a program
without these spans holds none of them: every helper then returns
nothing, and the readers report nothing."""
from __future__ import annotations

import bisect
from collections import Counter

from portbench.breakdown import HAND_WRITTEN, attributed, driver, window
from portbench.devtrace import gaps, kernel_function

CALL = {"vggt": "vggt.call", "lm": "prefill.call"}  # a driver's engine-call span
LONGEST_S = 0.5  # no device activity of a cell runs longer
MATCH_S = 2e-3  # a call span and the harness's record of the call end this close
NEAR_S = 5e-3  # the profiler's timeline lies this close to the spans' clock
COPY = "Memcpy DtoH"  # a readback's copy to the host
DEEP_S = 0.2e-3  # a span edge deeper than this inside an activity is misplaced
MISFIT = 0.1  # a call with a larger share of its span edges misplaced is left out


def host(ev) -> tuple[float, float]:
    return ev["t"] - ev["dur_s"], ev["t"]


def device(ev) -> tuple[float, float] | None:
    if ev.get("dev_start_s") is None:
        return None
    return ev["t"] + ev["dev_start_s"], ev["t"] + ev["dev_end_s"]


def children(run) -> dict:
    """Span id -> the spans (events with an ``id``) opened directly in it."""
    out = {}
    for ev in run.events:
        if ev.get("parent") is not None and "id" in ev:
            out.setdefault(ev["parent"], []).append(ev)
    return out


def calls(run) -> list:
    """(call span, its child spans) for each engine call of the driver's
    kind wholly inside the profiled sub-window."""
    w = window(run)
    phase = CALL.get(run.config.get("driver"))
    if w is None or phase is None or not run.events:
        return []
    kids = children(run)
    return [(ev, kids.get(ev["id"], [])) for ev in run.events
            if ev["phase"] == phase and "id" in ev
            and w[0] <= host(ev)[0] and host(ev)[1] <= w[1]]


def model(kids: list) -> dict | None:
    return next((k for k in kids if k["phase"] == "model"), None)


def parts(model_ev: dict, keep) -> list:
    """Device intervals of the model span's parts that ``keep(name, labels)``."""
    t = model_ev["t"]
    return [(t + a, t + b) for name, labels, a, b in model_ev.get("parts") or ()
            if a is not None and keep(name, labels)]


def landmarks(run) -> list:
    """(profiler time, spans' time) of each readback span's end: the end
    of the copy to the host nearest it, and the span's device end."""
    ends = sorted(k[2] for k in run.profile.get("kernels") or () if k[0].startswith(COPY))
    out = []
    for ev in run.events:
        if ev["phase"] == "readback" and device(ev) is not None and ends:
            y = device(ev)[1]
            i = bisect.bisect_left(ends, y)
            x = min(ends[max(0, i - 1):i + 1], key=lambda e: abs(e - y))
            if abs(x - y) < NEAR_S:
                out.append((x, y))
    return sorted(out)


def fit(marks: list, call: dict) -> tuple[float, float, float] | None:
    """(x1, shift, drift) such that ``x + shift + drift * (x - x1)`` puts
    profiler time ``x`` on the spans' clock over ``call``: the line through
    the call's own landmark and the one before it (after it, for the first
    in the trace); None when the call has no landmark."""
    a, b = device(call)
    i = next((i for i, (_, y) in enumerate(marks) if a <= y <= b), None)
    if i is None:
        return None
    x1, y1 = marks[i]
    j = i - 1 if i > 0 else i + 1
    drift = 0.0 if j >= len(marks) else (y1 - marks[j][1]) / (x1 - marks[j][0]) - 1.0
    return x1, y1 - x1, drift


class Placed:
    """One call on the spans' clock: the device activities around it,
    moved and sorted by start (``ks``), and the harness's activity -> its
    moved copy (``of``)."""

    def __init__(self, call: dict, kids: list, near: list, line: tuple):
        x1, shift, drift = line
        self.call, self.kids, self.line = call, kids, line
        self.ks = [(n, x + shift + drift * (x - x1), y + shift + drift * (y - x1))
                   for n, x, y in near]
        self.of = dict(zip(near, self.ks))
        self.starts = [k[1] for k in self.ks]
        self.inside, self.edges = edges_inside(self)

    def starting_in(self, intervals) -> list:
        """Activities that start inside any of the (disjoint) intervals."""
        out = []
        for a, b in sorted(intervals):
            out += self.ks[bisect.bisect_left(self.starts, a):bisect.bisect_right(self.starts, b)]
        return out


def batch(run, call: dict):
    """The harness's record of ``call`` (``breakdown.attributed``), with its kernels."""
    if getattr(run, "_span_batches", None) is None:
        run._span_batches = attributed(run)
    a, b = host(call)
    return next(((bt, ks) for bt, ks in run._span_batches
                 if abs(bt.t0 - a) < MATCH_S and abs(bt.t1 - b) < MATCH_S), (None, []))


def complete(run, p: Placed) -> bool:
    """Whether the call's ``model`` span holds the hand-written launches
    the counter expects for it."""
    bt, _ = batch(run, p.call)
    m = model(p.kids)
    if bt is None or m is None or device(m) is None:
        return False
    want = Counter(launch.kernel + "_kernel" for launch in driver(run).launches(run, bt))
    got = Counter(kernel_function(k[0]) for k in p.starting_in([device(m)]))
    return all(got[k] == n for k, n in want.items())


def placed(run) -> tuple[dict, Counter]:
    """Call id -> ``Placed`` for the sub-window's calls that are placed and
    complete, and the number left out for each reason; one fit a run,
    shared by its readers."""
    if getattr(run, "_span_calls", None) is None:
        raw = sorted(run.profile.get("kernels") or (), key=lambda k: k[1])
        starts = [k[1] for k in raw]
        marks = landmarks(run)
        out, left = {}, Counter()
        for call, kids in calls(run):
            line = fit(marks, call) if device(call) is not None else None
            if line is None:
                left["no readback copy in the trace"] += 1
                continue
            a, b = device(call)
            near = raw[bisect.bisect_left(starts, a - NEAR_S - LONGEST_S):
                       bisect.bisect_right(starts, b + NEAR_S)]
            p = Placed(call, kids, near, line)
            if p.inside > MISFIT * p.edges:
                left["span edges inside activities"] += 1
            elif not complete(run, p):
                left["launches the trace did not hold as the counter expects"] += 1
            else:
                out[call["id"]] = p
        run._span_calls = (out, left)
    return run._span_calls


def glue(ks) -> float:
    return sum(t1 - t0 for n, t0, t1 in ks if kernel_function(n) not in HAND_WRITTEN)


def is_attention(name: str, labels: dict) -> bool:
    return name == "attn" or (name == "mixer" and labels.get("kind") == "attn")


def is_ffn(name: str, labels: dict) -> bool:
    return name == "ffn"


def part_glue(run, keep) -> tuple[float, list] | None:
    """Glue seconds of the kernels that start inside the parts ``keep``
    selects, over the placed calls of the sub-window, and those calls;
    None when no call is placed."""
    got, _ = placed(run)
    if not got:
        return None
    return (sum(glue(p.starting_in(parts(model(p.kids), keep))) for p in got.values()),
            [p.call for p in got.values()])


def idle_in(p: Placed, a: float, b: float) -> list:
    """The gaps in device activity inside the host interval [a, b]."""
    lo, hi = bisect.bisect_left(p.starts, a - LONGEST_S), bisect.bisect_right(p.starts, b)
    return gaps([(max(t0, a), min(t1, b)) for _, t0, t1 in p.ks[lo:hi] if t1 > a], a, b)


def busy_share(p: Placed, intervals) -> tuple[float, float]:
    """(device-busy seconds, length) summed over host intervals."""
    busy = length = 0.0
    for a, b in intervals:
        length += b - a
        busy += (b - a) - sum(y - x for x, y in idle_in(p, a, b))
    return busy, length


def edges_inside(p: Placed) -> tuple[int, int]:
    """(span edges of the call, its children and its model parts that fall
    more than ``DEEP_S`` inside an activity, all of them): a CUDA event
    runs between two activities of its stream, so a right fit leaves none
    that deep."""
    edges = [x for ev in [p.call] + p.kids if device(ev) is not None for x in device(ev)]
    m = model(p.kids)
    edges += [x for iv in parts(m, lambda n, lb: True) for x in iv] if m else []
    inside = 0
    for e in edges:
        i = bisect.bisect_right(p.starts, e - DEEP_S) - 1
        inside += i >= 0 and p.ks[i][2] > e + DEEP_S
    return inside, len(edges)


def note(run) -> str | None:
    """The fit and the calls left out; idle time inside the placed calls by
    the innermost host span; glue by model part (the rest: the call's
    device interval less its attention and FFN parts) beside the harness's
    glue for the same calls; and the kernels that the call's children's
    device intervals, and the call's own, hold against those the harness
    attributes to the call by its host interval."""
    got, left = placed(run)
    if not got and not left:
        return None
    idle, glue_by = {}, {"attention": 0.0, "FFN": 0.0, "other": 0.0}
    held = in_calls = want = same = same_call = inside = n_edges = 0
    between = []  # the harness's kernels in no child: how far from a child's edge
    harness_glue = 0.0
    for p in got.values():
        call, kids = p.call, p.kids
        for g in idle_in(p, *host(call)):
            rest = g[1] - g[0]
            for k in kids:
                ka, kb = host(k)
                d = max(0.0, min(g[1], kb) - max(g[0], ka))
                idle[k["phase"]] = idle.get(k["phase"], 0.0) + d
                rest -= d
            idle[call["phase"]] = idle.get(call["phase"], 0.0) + rest
        inside, n_edges = inside + p.inside, n_edges + p.edges
        spans = [device(k) for k in kids if device(k) is not None]
        whole = p.starting_in([device(call)])
        held_ks = [k for k in whole if any(x <= k[1] <= y for x, y in spans)]
        m = model(kids)
        att, ffn = p.starting_in(parts(m, is_attention)), p.starting_in(parts(m, is_ffn))
        glue_by["attention"] += glue(att)
        glue_by["FFN"] += glue(ffn)
        glue_by["other"] += glue(whole) - glue(att) - glue(ffn)
        mine = [p.of[k] for k in batch(run, call)[1] if k in p.of]
        want += len(mine)
        held += len(held_ks)
        in_calls += len(whole)
        same += sorted(held_ks) == sorted(mine)
        same_call += sorted(whole) == sorted(mine)
        harness_glue += glue(mine)
        edges = [e for x in spans for e in x]
        between += [min(abs(k[1] - e) for e in edges) for k in set(mine) - set(held_ks)]
    shifts = sorted(1e6 * p.line[1] for p in got.values()) or [0.0]
    drifts = sorted(1e6 * p.line[2] for p in got.values()) or [0.0]
    out = (f"spans: {len(got)} of {len(got) + sum(left.values())} engine calls of the profiled "
           f"sub-window placed on the spans' clock by their readback copies (shift "
           f"{shifts[0]:+.1f}..{shifts[-1]:+.1f} us, drift {drifts[0]:+.1f}..{drifts[-1]:+.1f} "
           f"us/s; {inside} of {n_edges} span edges deeper than {1e3 * DEEP_S:.1f} ms inside an "
           f"activity)")
    out += "".join(f"; left out, {why}: {n}" for why, n in sorted(left.items()))
    if not got:
        return out
    by_span = ", ".join(f"{k} {1e3 * v:.1f}" for k, v in sorted(idle.items(), key=lambda kv: -kv[1]))
    glue_ms = ", ".join(f"{k} {1e3 * v:.1f}" for k, v in glue_by.items())
    return (out + f"; device idle inside them {1e3 * sum(idle.values()):.1f} ms by innermost "
            f"host span ({by_span}); glue by model part, ms: {glue_ms} (sum "
            f"{1e3 * sum(glue_by.values()):.1f}, the harness's for the same calls "
            f"{1e3 * harness_glue:.1f}); kernels held by the children's device intervals {held}, "
            f"by the calls' {in_calls}, attributed by the harness {want} (the same kernels in "
            f"{same} and {same_call} of {len(got)} calls"
            + (f"; {len(between)} of the harness's in no child, at most "
               f"{1e6 * max(between):.1f} us from a child's edge)" if between else ")"))
