"""Per-request span tracing for the serving stack (port of
``repro/obs/trace.py``).

Every request moving through an engine leaves a chain of *span events*:

    enqueue -> admit -> prefill -> decode -> complete | evicted | failed

Engines emit through the module-level `emit()` / `span()` / `part()`
entry points; when no tracer is installed each is a single `is None`
check, so the un-telemetered hot path pays nothing.  An installed
`Tracer` keeps a bounded ring buffer (served by the `/trace` endpoint)
and can mirror every event to a JSONL file for offline tooling.

Spans nest.  Each `span()` records one event when it closes, with an
`id` and the `parent` id of the span open around it on the same thread
(an `emit()` inside a span carries that span's id as its `parent`).  A
span opened with ``parts=True`` collects the `part()` regions inside it
into its own event's `parts` list instead of one event each, so a model
forward costs one ring slot however many layers it has.

Timestamps: `t` is `time.perf_counter()` at the end (monotonic — use
for intra-process ordering and durations), `wall` is `time.time()`
(epoch — use to line events up with external logs).  On a CUDA machine
a span also records a CUDA event on the current stream at entry and at
exit; `dev_start_s`/`dev_end_s` are the times the stream reached them,
written as offsets from `t` on the same host clock, and each part's
interval likewise.  They are resolved against an *anchor*: a CUDA event
recorded with its host time by `anchor()` right after a synchronize the
engine already makes (or by the reader, lazily), so tracing adds no
host synchronize to an engine call.  `span()` additionally wraps the
body in `torch.profiler.record_function` (and, with a CUDA device, an
NVTX range) so profiler traces carry the same phase names as the JSONL
stream.  `docs/port_spans.md` draws the span tree the serving stack
records.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

# Canonical phase names, in request-lifecycle order.  `decode_burst` is a
# batch-level event (one per decode wave, not per request) and is excluded
# from per-request chains.
PHASES = ("enqueue", "admit", "prefill", "decode", "forward", "complete", "evicted", "failed")
TERMINAL = ("complete", "evicted", "failed")

_IDS = itertools.count(1)  # process-unique span ids
ANCHORS = 16  # recent anchors whose bounds sharpen each other
ANCHOR_SPAN_S = 3.0  # ... when this close on the host clock (the clocks drift apart)
_local = threading.local()  # per-thread stack of open spans


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


@dataclass
class SpanEvent:
    phase: str
    t: float                      # monotonic seconds (time.perf_counter)
    wall: float                   # epoch seconds (time.time)
    request: Optional[str] = None
    dur_s: Optional[float] = None
    labels: Dict[str, Any] = field(default_factory=dict)
    id: Optional[int] = None      # span id (spans only)
    parent: Optional[int] = None  # id of the span open around it on its thread
    dev_start_s: Optional[float] = None  # device interval, offsets from t
    dev_end_s: Optional[float] = None
    parts: Optional[list] = None  # [name, labels, dev_start_s, dev_end_s] per part
    _marks: Any = field(default=None, repr=False)  # unresolved CUDA events

    def to_dict(self) -> dict:
        d = {"phase": self.phase, "t": self.t, "wall": self.wall}
        if self.request is not None:
            d["request"] = self.request
        if self.dur_s is not None:
            d["dur_s"] = self.dur_s
        if self.labels:
            d.update(self.labels)
        for k in ("id", "parent", "dev_start_s", "dev_end_s"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.parts is not None:
            d["parts"] = [list(p) for p in self.parts]
        return d


class Tracer:
    """Bounded ring buffer of span events + optional JSONL mirror."""

    def __init__(self, capacity: int = 2048, jsonl_path: Optional[str] = None):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._file = open(jsonl_path, "a", buffering=1) if jsonl_path else None
        self.jsonl_path = jsonl_path
        self._cuda = torch.cuda.is_available()  # record device intervals
        self._nvtx = self._cuda
        self._new_event = lambda: torch.cuda.Event(enable_timing=True)
        self._free: list = []  # CUDA events to reuse
        self._pending: list = []  # events with marks, closed since the last anchor
        self._anchors: list = []  # (anchor event, host time, its events), unresolved
        self._recent: deque = deque(maxlen=ANCHORS)  # (anchor event, host time before it)

    def emit(
        self,
        phase: str,
        request: Optional[str] = None,
        dur_s: Optional[float] = None,
        **labels: Any,
    ) -> SpanEvent:
        st = _stack()
        ev = SpanEvent(
            phase=phase,
            t=time.perf_counter(),
            wall=time.time(),
            request=request,
            dur_s=dur_s,
            labels=labels,
            parent=st[-1].id if st else None,
        )
        self._append(ev)
        return ev

    def _append(self, ev: SpanEvent) -> None:
        with self._lock:
            self._ring.append(ev)
            if ev._marks is not None:
                self._pending.append(ev)
                if len(self._pending) > self.capacity:  # no anchor comes: drop the oldest marks
                    for old in self._pending[: self.capacity // 2]:
                        self._drop(old)
                        self._write(old)
                    del self._pending[: self.capacity // 2]
            else:
                self._write(ev)

    def _write(self, ev: SpanEvent) -> None:
        if self._file is not None:
            self._file.write(json.dumps(ev.to_dict()) + "\n")

    # -- device intervals ----------------------------------------------------

    def _mark(self):
        """A CUDA event recorded on the current stream (reused when one is free)."""
        try:
            e = self._free.pop()
        except IndexError:
            e = self._new_event()
        e.record()
        return e

    def anchor(self) -> None:
        """Record an anchor: call right after a synchronize, when the
        stream is idle, so the device reaches the anchor right after its
        host time.  Events closed before it resolve against it once it has
        completed (at the next anchor or read); nothing here waits for the
        device."""
        if not self._cuda:
            return
        with self._lock:  # marks of every pending event precede the anchor
            self._add_anchor()
            self._resolve()

    def _add_anchor(self) -> None:
        h = time.perf_counter()  # before the record: the device cannot reach it earlier
        a = self._new_event()
        a.record()
        self._anchors.append((a, h, self._pending))
        self._recent.append((a, h))
        self._pending = []

    def _host_time(self, a, h: float) -> float:
        """When the device reached anchor ``a`` on the host clock: the
        latest of the lower bounds that ``a`` and the completed anchors
        around it give.  A thread switch or a slow call before a record
        only loosens its own bound, and a busy stream delays the anchor
        past its bound alike; the tightest one wins."""
        best = h
        for b, hb in self._recent:
            if b is a or abs(hb - h) > ANCHOR_SPAN_S or not b.query():
                continue
            if hb < h:  # b before a on the stream
                best = max(best, hb + b.elapsed_time(a) / 1e3)
            else:
                best = max(best, hb - a.elapsed_time(b) / 1e3)
        return best

    def _resolve(self) -> None:
        """Resolve the events of every completed anchor.  Caller holds the
        lock."""
        keep = []
        for a, h, evs in self._anchors:
            if not a.query():
                keep.append((a, h, evs))
                continue
            h = self._host_time(a, h)
            for ev in evs:
                self._apply(ev, a, h)
                self._write(ev)
        self._anchors = keep

    def _apply(self, ev: SpanEvent, a, h: float) -> None:
        """Device times of ``ev``'s marks, as offsets from ``ev.t``: each
        mark precedes the anchor ``a`` (reached at host time ``h``) on the
        stream."""
        start, end, parts = ev._marks

        def host(m) -> float:
            return h - m.elapsed_time(a) / 1e3 - ev.t

        try:
            ev.dev_start_s, ev.dev_end_s = host(start), host(end)
            if parts is not None:
                ev.parts = [[n, lb, host(m0), host(m1)] for n, lb, m0, m1 in parts]
        except RuntimeError:  # a mark on another stream not yet complete: no interval
            self._drop(ev)
            return
        self._release(ev)

    def _release(self, ev: SpanEvent) -> None:
        start, end, parts = ev._marks
        self._free += [start, end]
        for _, _, m0, m1 in parts or ():
            self._free += [m0, m1]
        ev._marks = None

    def _drop(self, ev: SpanEvent) -> None:
        """Give up ``ev``'s device interval (its parts keep their names)."""
        parts = ev._marks[2]
        self._release(ev)
        ev.dev_start_s = ev.dev_end_s = None
        ev.parts = None if parts is None else [[n, lb, None, None] for n, lb, _, _ in parts]

    def _settle(self) -> None:
        """Resolve the recorded intervals, anchoring the events closed
        since the last anchor now (a reader's synchronize, not an engine
        call's).  It waits for the device outside the lock, so engine
        threads go on recording meanwhile."""
        with self._lock:
            drained = self._mark() if self._pending else None
        if drained is not None:  # wait for the stream, so the anchor finds it idle
            drained.synchronize()
        with self._lock:
            if drained is not None:
                self._free.append(drained)
                self._add_anchor()
            last = self._anchors[-1][0] if self._anchors else None
        if last is not None:
            last.synchronize()
        with self._lock:
            self._resolve()

    # -- reading -------------------------------------------------------------

    def recent(self, n: Optional[int] = None, request: Optional[str] = None) -> List[SpanEvent]:
        self._settle()
        with self._lock:
            evs = list(self._ring)
        if request is not None:
            evs = [e for e in evs if e.request == request]
        if n is not None:
            evs = evs[-int(n):]
        return evs

    def phases(self, request: str) -> List[str]:
        """Ordered phase names seen for one request (duplicates collapsed
        to first occurrence) — the span-chain a completeness check asserts."""
        seen: List[str] = []
        for ev in self.recent(request=request):
            if ev.phase not in seen:
                seen.append(ev.phase)
        return seen

    def clear(self) -> None:
        self._settle()
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        self._settle()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# -- module-level install point ----------------------------------------------

_tracer: Optional[Tracer] = None


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with None, uninstall) the process tracer; returns the
    previous one so callers can restore it."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


def uninstall() -> Optional[Tracer]:
    return install(None)


def current() -> Optional[Tracer]:
    return _tracer


def emit(phase: str, request: Optional[str] = None, dur_s: Optional[float] = None, **labels: Any):
    """Fire-and-forget span event; no-op (one None check) when tracing is off."""
    tr = _tracer
    if tr is None:
        return None
    return tr.emit(phase, request=request, dur_s=dur_s, **labels)


def anchor() -> None:
    """Anchor the device intervals recorded so far to the host clock; call
    right after a synchronize.  No-op when tracing is off."""
    tr = _tracer
    if tr is not None:
        tr.anchor()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    """An open span: its id, parent, host start, entry mark and parts."""

    __slots__ = ("tr", "phase", "request", "labels", "id", "parent", "t0", "m0", "rf", "parts",
                 "labelled")

    def __init__(self, tr: Tracer, phase: str, request, labels: dict, parts: bool):
        self.tr, self.phase, self.request, self.labels = tr, phase, request, labels
        self.parts = [] if parts else None
        self.labelled = 0  # parts before this index went through `label_parts`

    def __enter__(self) -> "_Span":
        st = _stack()
        self.parent = st[-1].id if st else None
        self.id = next(_IDS)
        st.append(self)
        self.rf = torch.profiler.record_function(self.phase)
        self.rf.__enter__()
        if self.tr._nvtx:
            torch.cuda.nvtx.range_push(self.phase)
        self.m0 = self.tr._mark() if self.tr._cuda else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tr
        m1 = tr._mark() if tr._cuda else None
        t = time.perf_counter()
        if tr._nvtx:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(None, None, None)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:
            st.remove(self)
        ev = SpanEvent(phase=self.phase, t=t, wall=time.time(), request=self.request,
                       dur_s=t - self.t0, labels=self.labels, id=self.id, parent=self.parent)
        if m1 is not None:
            ev._marks = (self.m0, m1, self.parts)
        elif self.parts is not None:
            ev.parts = [[n, lb, None, None] for n, lb, _, _ in self.parts]
        tr._append(ev)
        return False


def span(phase: str, request: Optional[str] = None, *, parts: bool = False, **labels: Any):
    """Time a phase as one span event, nested under the span open around
    it on this thread, and line it up with profiler traces.

    Wraps the body in `torch.profiler.record_function` (so `torch.profiler`
    timelines carry the phase name) and, when CUDA is available, in an NVTX
    range; records the device interval on CUDA.  ``parts=True`` collects
    the `part()` regions opened directly inside it into its event.  The
    context value is the open span (its ``labels`` may still be set), or
    None when tracing is off.
    """
    tr = _tracer
    if tr is None:
        return _NOOP
    return _Span(tr, phase, request, labels, parts)


class _Part:
    __slots__ = ("owner", "entry")

    def __init__(self, owner: _Span, name: str, labels: dict):
        self.owner = owner
        self.entry = [name, labels, None, None]

    def __enter__(self):
        o = self.owner
        if o.tr._cuda:
            self.entry[2] = o.tr._mark()
        o.parts.append(self.entry)
        return None

    def __exit__(self, *exc) -> bool:
        o = self.owner
        if o.tr._cuda:
            self.entry[3] = o.tr._mark()
        return False


def label_parts(**labels: Any) -> None:
    """Add ``labels`` to the parts recorded since the last call, in the
    ``parts=True`` span open around them: a caller labels the parts of the
    code it called (which block of a model they belong to).  No-op unless
    such a span is the innermost open span on this thread."""
    tr = _tracer
    if tr is None:
        return
    st = _stack()
    if st and st[-1].parts is not None:
        sp = st[-1]
        for entry in sp.parts[sp.labelled:]:
            entry[1] = {**entry[1], **labels}
        sp.labelled = len(sp.parts)


def part(name: str, **labels: Any):
    """A region of a model forward, recorded compactly: a
    ``[name, labels, dev_start_s, dev_end_s]`` entry of the ``parts=True``
    span open around it.  No-op unless such a span is the innermost open
    span on this thread."""
    tr = _tracer
    if tr is None:
        return _NOOP
    st = _stack()
    if not st or st[-1].parts is None:
        return _NOOP
    return _Part(st[-1], name, labels)
