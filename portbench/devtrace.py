"""The profiled sub-window and its reduction to kernel intervals.

A thread starts ``torch.profiler`` at the end of a traced run's window
and stops it when the window closes.  Right after starting and before
stopping it runs a marked ``record_function`` on its own thread, whose
profiler timestamp against ``time.perf_counter`` aligns the device
timeline with the host clock.  The reduction returns every device
activity as ``(name, start, end)`` in host seconds from the window start.
"""
from __future__ import annotations

import threading
import time

MARK = "portbench.mark"


def kernel_function(name: str) -> str:
    """A device kernel's function name without return type, anonymous
    namespace, template arguments or parameters:
    ``void (anonymous namespace)::two_stage_attention_kernel<64, true>(...)``
    -> ``two_stage_attention_kernel``."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    cut = len(s)
    for ch in "<(":
        i = s.find(ch)
        if i != -1:
            cut = min(cut, i)
    return s[:cut].strip()


class SubWindow(threading.Thread):
    """Profile from host time ``start_at`` to ``stop_at`` (perf_counter)."""

    def __init__(self, start_at: float, stop_at: float, origin: float):
        super().__init__(name="portbench-profiler", daemon=True)
        self.start_at, self.stop_at, self.origin = start_at, stop_at, origin
        self.prof = None
        self.h_start = self.h_stop = None
        self.error = None

    def _mark(self):
        import torch

        h = time.perf_counter()
        with torch.profiler.record_function(MARK):
            torch.empty(1)
        return h

    def run(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        try:
            time.sleep(max(0.0, self.start_at - time.perf_counter()))
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.h_start = self._mark()
            time.sleep(max(0.0, self.stop_at - time.perf_counter()))
            self.h_stop = self._mark()
            self.prof.stop()
        except Exception as e:  # the traced metrics then read nothing
            self.error = repr(e)

    def reduce(self) -> dict:
        """{"window": (a, b), "kernels": [(name, t0, t1)]} in seconds from
        the window origin; empty kernels when the profiler saw no device."""
        from torch.autograd import DeviceType

        if self.prof is None or self.h_stop is None:
            return {"window": None, "kernels": [], "error": self.error or "profiler not run"}
        events = self.prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == MARK)
        if not marks:
            return {"window": None, "kernels": [], "error": "no host mark in the trace"}
        offset = marks[0] / 1e6 - self.h_start  # profiler seconds minus host seconds
        kernels = []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                t0 = e.time_range.start / 1e6 - offset - self.origin
                t1 = e.time_range.end / 1e6 - offset - self.origin
                kernels.append((e.name, t0, t1))
        kernels.sort(key=lambda k: k[1])
        return {"window": (self.h_start - self.origin, self.h_stop - self.origin),
                "kernels": kernels, "error": None}


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [a, b] intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
