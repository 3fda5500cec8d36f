"""Per-request span tracing for the serving stack (port of
``repro/obs/trace.py``).

Every request moving through an engine leaves a chain of *span events*:

    enqueue -> admit -> prefill -> decode -> complete | evicted | failed

Engines emit through the module-level `emit()` / `span()` entry points;
when no tracer is installed both are a single `is None` check, so the
un-telemetered hot path pays nothing.  An installed `Tracer` keeps a
bounded ring buffer (served by the `/trace` endpoint) and can mirror
every event to a JSONL file for offline tooling.

Timestamps: `t` is `time.perf_counter()` (monotonic — use for intra-
process ordering and durations), `wall` is `time.time()` (epoch — use to
line events up with external logs).  `span()` additionally wraps the
body in `torch.profiler.record_function` (and, with a CUDA device, an
NVTX range) so profiler traces carry the same phase names as the JSONL
stream.
"""

from __future__ import annotations

import contextlib
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


@dataclass
class SpanEvent:
    phase: str
    t: float                      # monotonic seconds (time.perf_counter)
    wall: float                   # epoch seconds (time.time)
    request: Optional[str] = None
    dur_s: Optional[float] = None
    labels: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"phase": self.phase, "t": self.t, "wall": self.wall}
        if self.request is not None:
            d["request"] = self.request
        if self.dur_s is not None:
            d["dur_s"] = self.dur_s
        if self.labels:
            d.update(self.labels)
        return d


class Tracer:
    """Bounded ring buffer of span events + optional JSONL mirror."""

    def __init__(self, capacity: int = 2048, jsonl_path: Optional[str] = None):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._file = open(jsonl_path, "a", buffering=1) if jsonl_path else None
        self.jsonl_path = jsonl_path

    def emit(
        self,
        phase: str,
        request: Optional[str] = None,
        dur_s: Optional[float] = None,
        **labels: Any,
    ) -> SpanEvent:
        ev = SpanEvent(
            phase=phase,
            t=time.perf_counter(),
            wall=time.time(),
            request=request,
            dur_s=dur_s,
            labels=labels,
        )
        with self._lock:
            self._ring.append(ev)
            if self._file is not None:
                self._file.write(json.dumps(ev.to_dict()) + "\n")
        return ev

    def recent(self, n: Optional[int] = None, request: Optional[str] = None) -> List[SpanEvent]:
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
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
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


@contextlib.contextmanager
def span(phase: str, request: Optional[str] = None, emit_event: bool = True, **labels: Any):
    """Time a phase and line it up with profiler traces.

    Wraps the body in `torch.profiler.record_function` (so `torch.profiler`
    timelines carry the phase name) and, when CUDA is available, in
    `torch.cuda.nvtx.range` (so do device timelines), and, unless
    `emit_event=False`, emits one event with the measured wall duration.
    """
    tr = _tracer
    if tr is None:
        yield
        return
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(phase))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(phase))
        yield
    if emit_event:
        tr.emit(phase, request=request, dur_s=time.perf_counter() - t0, **labels)
