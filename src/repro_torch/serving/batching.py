"""Serving-batching machinery for the bucketed engines (port of
``repro/serving/batching.py``, in the part ``VGGTEngine`` needs).

* Requests are quantized onto **shape buckets**; the engine counts the
  first use of each ``(bucket, masked)`` as ``compiles`` (the stats schema
  is shared with the reference; eager PyTorch compiles nothing).
* Requests **coalesce** in per-group queues and are flushed into one
  forward when a group fills ``max_batch`` items, when its oldest request
  passes ``max_wait_s`` (``poll()``), or explicitly (``MicroBatchQueue``).
* Every flush lands in per-bucket **stats**: first uses, calls,
  p50/p95 latency, throughput (``BucketStats`` / ``ServeStats``).

Admission control, the degradation ladder, precision tiers, compiled
schedules and the telemetry exports are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, ClassVar, Hashable, Optional

import numpy as np

__all__ = [
    "Bucket",
    "BucketStats",
    "ServeStats",
    "SchedulerStats",
    "ServeError",
    "DeadlineExceeded",
    "NumericFault",
    "PendingRequest",
    "MicroBatchQueue",
    "next_pow2",
    "pick_bucket",
    "LATENCY_WINDOW",
]


class ServeError(RuntimeError):
    """Base class for serving-layer request failures with defined
    semantics.  ``PendingRequest.result()`` re-raises these directly;
    anything else a micro-batch raises stays wrapped."""


class DeadlineExceeded(ServeError):
    """A request missed its ``deadline_s`` while queued and was evicted
    instead of being served late."""


class NumericFault(ServeError):
    """The request's forward produced non-finite outputs and was
    quarantined: only this request fails, co-batched requests keep their
    results."""


def next_pow2(n: int, floor: int = 16) -> int:
    """Smallest power-of-two bucket size >= n (never below ``floor``)."""
    p = floor
    while p < n:
        p *= 2
    return p


def pick_bucket(ladder: tuple[int, ...], n: int) -> int:
    """Smallest ladder entry >= n; an oversize request gets an exact-size
    bucket of its own (it can never coalesce anyway)."""
    return next((x for x in ladder if x >= n), n)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Base class for one cached shape.  Subclasses declare int size
    fields in display order and set ``AXES`` to their single-letter labels,
    e.g. ``(batch, frames, patches)`` with ``("b", "s", "p")`` prints as
    ``b4xs2xp24``."""

    AXES: ClassVar[tuple[str, ...]] = ()

    def sizes(self) -> tuple:
        """The numeric sort key for stats tables."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def __str__(self) -> str:
        return "x".join(f"{a}{n}" for a, n in zip(self.AXES, self.sizes()))


LATENCY_WINDOW = 1024  # percentile window; totals keep the full history


@dataclasses.dataclass
class BucketStats:
    """Per-bucket serving statistics; ``items`` counts the engine's unit
    of work (scenes for VGGT)."""

    compiles: int = 0  # first uses of the bucket (masked and unmasked apart)
    calls: int = 0
    items: int = 0  # real items served
    padded_items: int = 0  # bucket slack (padding waste)
    total_s: float = 0.0
    # bounded: a long-running engine must not grow per-call state forever
    latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW)
    )

    def _pct(self, q: float) -> float:
        return float(np.percentile(self.latencies_s, q)) if self.latencies_s else 0.0

    @property
    def p50_ms(self) -> float:
        return self._pct(50) * 1e3

    @property
    def p95_ms(self) -> float:
        return self._pct(95) * 1e3

    @property
    def items_per_s(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "compiles": self.compiles,
            "calls": self.calls,
            "items": self.items,
            "padded_items": self.padded_items,
            "p50_ms": round(self.p50_ms, 3),
            "p95_ms": round(self.p95_ms, 3),
            "items_per_s": round(self.items_per_s, 2),
        }


@dataclasses.dataclass
class SchedulerStats:
    """Eviction and quarantine counters of a serving engine."""

    deadline_evictions: int = 0
    numeric_faults: int = 0  # requests quarantined on non-finite outputs

    def summary(self) -> dict:
        return {
            "deadline_evictions": self.deadline_evictions,
            "numeric_faults": self.numeric_faults,
        }


class ServeStats:
    """Per-bucket serving statistics container.  ``unit`` names the item
    column in ``format()``; ``kind`` tags the engine family in
    ``summary()``."""

    unit = "items"
    kind = "generic"

    def __init__(self):
        self.buckets: dict[Bucket, BucketStats] = {}
        self.scheduler = SchedulerStats()

    def bucket(self, b: Bucket) -> BucketStats:
        return self.buckets.setdefault(b, BucketStats())

    @property
    def compiles(self) -> int:
        return sum(s.compiles for s in self.buckets.values())

    @property
    def calls(self) -> int:
        return sum(s.calls for s in self.buckets.values())

    @property
    def items(self) -> int:
        return sum(s.items for s in self.buckets.values())

    def _sorted(self) -> list[tuple[Bucket, BucketStats]]:
        return sorted(self.buckets.items(), key=lambda kv: (type(kv[0]).__name__, kv[0].sizes()))

    def summary(self) -> dict:
        """``{"kind", "unit", "totals": {compiles, calls, items},
        "buckets": {str(bucket): BucketStats.summary()}, "scheduler": ...}``."""
        return {
            "kind": self.kind,
            "unit": self.unit,
            "totals": {"compiles": self.compiles, "calls": self.calls, "items": self.items},
            "buckets": {str(b): s.summary() for b, s in self._sorted()},
            "scheduler": self.scheduler.summary(),
        }

    def format(self) -> str:
        unit = self.unit
        lines = [
            f"{'bucket':>16} {'compiles':>8} {'calls':>6} {unit:>7} "
            f"{'pad':>5} {'p50ms':>8} {'p95ms':>8} {unit + '/s':>9}"
        ]
        for b, s in self._sorted():
            lines.append(
                f"{str(b):>16} {s.compiles:>8} {s.calls:>6} {s.items:>7} "
                f"{s.padded_items:>5} {s.p50_ms:>8.1f} {s.p95_ms:>8.1f} "
                f"{s.items_per_s:>9.1f}"
            )
        return "\n".join(lines)


_REQ_IDS = itertools.count(1)  # process-unique request ids


@dataclasses.dataclass
class PendingRequest:
    """Base class for a queued request; ``result()`` is available after
    the engine flushes the request's micro-batch group.

    ``deadline_s`` is a soft SLA in seconds from enqueue — a request still
    queued at its deadline is evicted with :class:`DeadlineExceeded`.
    """

    req_id: str = dataclasses.field(default_factory=lambda: f"r{next(_REQ_IDS)}", kw_only=True)
    deadline_s: Optional[float] = dataclasses.field(default=None, kw_only=True)
    t_enqueue: float = dataclasses.field(default_factory=time.perf_counter, kw_only=True)
    _result: Optional[Any] = dataclasses.field(default=None, kw_only=True)
    _error: Optional[BaseException] = dataclasses.field(default=None, kw_only=True)

    @property
    def ready(self) -> bool:
        return self._result is not None or self._error is not None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        return (time.perf_counter() if now is None else now) >= self.t_enqueue + self.deadline_s

    def result(self) -> Any:
        if isinstance(self._error, ServeError):
            raise self._error
        if self._error is not None:
            raise RuntimeError("request's micro-batch failed") from self._error
        if self._result is None:
            raise RuntimeError("request not flushed yet — call engine.flush()")
        return self._result

    def _deliver(self, result: Any) -> None:
        self._result = result

    def _fail(self, err: BaseException) -> None:
        self._error = err


class MicroBatchQueue:
    """Per-group pending-request queues with ``max_batch`` coalescing and
    deadline flushing.

    ``run(group_key, requests)`` is the engine's flush callback: it must
    execute the coalesced requests and ``_deliver`` each one's result.
    """

    def __init__(self, run: Callable[[Hashable, list[PendingRequest]], None],
                 max_batch: int, max_wait_s: float):
        self._run = run
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._queues: dict[Hashable, list[tuple[PendingRequest, int]]] = {}

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def add(self, key: Hashable, req: PendingRequest, size: int) -> PendingRequest:
        q = self._queues.setdefault(key, [])
        q.append((req, size))
        if size >= self.max_batch or sum(s for _, s in q) >= self.max_batch:
            self.flush_group(key)
        return req

    def poll(self) -> int:
        """Flush groups whose oldest request has waited past ``max_wait_s``.
        Returns the number of groups flushed."""
        now = time.perf_counter()
        due = [k for k, q in self._queues.items() if q and now - q[0][0].t_enqueue >= self.max_wait_s]
        for key in due:
            self.flush_group(key)
        return len(due)

    def flush(self) -> None:
        """Flush every pending group."""
        for key in [k for k, q in self._queues.items() if q]:
            self.flush_group(key)

    def evict_expired(self, stats: Optional[SchedulerStats] = None) -> int:
        """Fail queued requests whose deadline already passed with
        :class:`DeadlineExceeded`.  Returns the eviction count."""
        now = time.perf_counter()
        n = 0
        for q in self._queues.values():
            for r, _ in [e for e in q if e[0].expired(now)]:
                r._fail(DeadlineExceeded(
                    f"request missed its {r.deadline_s:.3f}s deadline while queued"
                ))
                n += 1
            q[:] = [e for e in q if not e[0].ready]
        if stats is not None:
            stats.deadline_evictions += n
        return n

    def fail_pending(self, err: BaseException) -> int:
        """Fail every queued request without running it.  Returns the count."""
        n = 0
        for q in self._queues.values():
            for r, _ in q:
                r._fail(err)
                n += 1
            q.clear()
        return n

    def flush_group(self, key: Hashable) -> None:
        q = self._queues.get(key, [])
        while q:
            # take requests up to max_batch items (an oversize request runs
            # alone in its own exact-size bucket)
            take, n = [], 0
            while q and (not take or n + q[0][1] <= self.max_batch):
                r, s = q.pop(0)
                take.append(r)
                n += s
            try:
                self._run(key, take)
            except Exception as e:
                # deliver the failure to every coalesced owner instead of
                # leaving popped requests forever un-ready
                for r in take:
                    if not r.ready:
                        r._fail(e)
                raise
