"""Shared serving-batching machinery for the bucketed engines (port of
``repro/serving/batching.py``; the VGGT engine is its one user so far).

The engines serve traffic the same way:

* requests are quantized onto **shape buckets** (``Bucket`` subclasses
  name the bucketed axes); the engine counts the first use of each
  ``(bucket, masked)`` in the stats' ``compiles`` field (the schema is
  the reference's; eager PyTorch compiles nothing);
* requests **coalesce** in per-group pending queues and are flushed into
  one forward when a group fills ``max_batch`` items, when its oldest
  request passes the ``max_wait_s`` deadline (``poll()``, driven by
  ``serving.server.AsyncServer``), or explicitly (``MicroBatchQueue``);
* every flush lands in per-bucket **stats** — compile count, p50/p95
  latency, throughput (``BucketStats`` / ``ServeStats``).

This module holds the engine-agnostic pieces; the engines own the model
calls, padding/masking, and result splitting; ``load_schedule`` resolves
an engine's compiled kernel schedule.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, ClassVar, Hashable, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "Bucket",
    "BucketStats",
    "ServeStats",
    "SchedulerStats",
    "ServingEngine",
    "ServeError",
    "DeadlineExceeded",
    "QueueFull",
    "NumericFault",
    "ServerStopped",
    "AdmissionController",
    "DegradeConfig",
    "DegradationController",
    "PendingRequest",
    "MicroBatchQueue",
    "TierSet",
    "load_schedule",
    "resolve_device",
    "next_pow2",
    "pick_bucket",
    "LATENCY_WINDOW",
]


class ServeError(RuntimeError):
    """Base class for serving-layer request failures with defined
    semantics (SLA miss, admission rejection, numeric quarantine,
    server shutdown).  ``PendingRequest.result()`` re-raises these
    *directly* so callers can catch the specific class; anything else a
    micro-batch raises is an engine bug and stays wrapped."""


class DeadlineExceeded(ServeError):
    """A request missed its ``deadline_s`` and was evicted — either from
    the pending queue (never admitted) or mid-decode (its slots were
    released to the batch).  Delivered through ``PendingRequest.result()``
    so the waiter sees the SLA miss, not a hang."""


class QueueFull(ServeError):
    """Admission control rejected (or shed) the request: the engine's
    bounded pending queue (``max_pending`` / ``max_queued_tokens``) was
    full and the request lost the shed ordering (lowest priority, then
    latest deadline, then newest arrival sheds first).  Raised from
    ``enqueue`` for the incoming request; delivered through ``result()``
    for a shed victim."""


class NumericFault(ServeError):
    """The request's forward produced non-finite activations (NaN/Inf —
    e.g. saturation blow-up at an aggressive quantization tier) and was
    quarantined: only this request fails, co-batched requests keep their
    bit-exact results.  Engines may retry once at a higher-precision
    tier before failing (``numeric_retry_tier``)."""


class ServerStopped(ServeError):
    """The serving loop stopped (``AsyncServer.stop(drain=False)``, or
    abort escalation after repeated poll failures) before this request
    was served."""


@runtime_checkable
class ServingEngine(Protocol):
    """The serving-engine surface every engine exposes and everything
    engine-agnostic (``serving.server.AsyncServer``, ``launch/serve.py``,
    dashboards) programs against.

    ``Engine`` (LM prefill/decode, continuous or bucket scheduling) and
    ``VGGTEngine`` (feed-forward scenes) both implement it:

    * ``enqueue(*work, priority=, deadline_s=)`` -> ``PendingRequest``;
      higher ``priority`` admits first, ``deadline_s`` (seconds from
      enqueue) evicts with :class:`DeadlineExceeded` when missed.
    * ``poll()`` -> int: one bounded scheduling turn (admissions /
      deadline flushes; the async server drives this on a timer).
    * ``flush()``: block until every pending request is served.
    * ``abort(err)`` -> int: fail everything pending without serving it.
    * ``stats``: a :class:`ServeStats` (unified ``summary()`` schema).
    * ``tiers``: the precision-tier table (name -> policy).
    """

    stats: "ServeStats"
    tiers: dict

    def enqueue(self, *args: Any, **kwargs: Any) -> "PendingRequest": ...

    def poll(self) -> int: ...

    def flush(self) -> None: ...

    def abort(self, err: Optional[BaseException] = None) -> int: ...


class TierSet:
    """Named precision tiers for a serving engine.

    Maps tier name -> quantization spec (``QuantPolicy`` | ``PrecisionPlan``
    | ``None`` for full precision) and lazily materializes each tier's
    parameter tree through the engine-supplied ``quantize`` callable on
    first use — a tier that never sees traffic costs nothing, including
    the default tier.  Shared by both engines so tier validation and the
    lazy cache cannot diverge between them.
    """

    def __init__(self, *, tiers, policy, default_tier, raw_params, quantize):
        if tiers is not None and policy is not None:
            raise ValueError("pass either policy= (one tier) or tiers=, not both")
        self.tiers = dict(tiers) if tiers is not None else {"default": policy}
        if not self.tiers:
            raise ValueError("tiers must name at least one tier")
        self.default_tier = (
            default_tier if default_tier is not None else next(iter(self.tiers))
        )
        if self.default_tier not in self.tiers:
            raise ValueError(
                f"default_tier {self.default_tier!r} not in tiers {sorted(self.tiers)}"
            )
        self._raw = raw_params
        self._quantize = quantize
        self._params: dict[str, Any] = {}

    @property
    def default_policy(self):
        return self.tiers[self.default_tier]

    def resolve(self, tier: Optional[str]) -> str:
        """Tier name with None -> default; unknown names raise."""
        t = self.default_tier if tier is None else tier
        if t not in self.tiers:
            raise KeyError(f"unknown tier {t!r}: expected one of {sorted(self.tiers)}")
        return t

    def params(self, tier: Optional[str]):
        """The tier's parameter tree (quantized lazily on first use)."""
        t = self.resolve(tier)
        p = self._params.get(t)
        if p is None:
            pol = self.tiers[t]
            p = self._raw if pol is None else self._quantize(pol)
            self._params[t] = p
        return p


def load_schedule(schedule):
    """Resolve an engine's ``schedule=`` argument -> ``(schedule, hash)``.

    Accepts ``None`` (implicit path), a path to a compiled
    ``KernelSchedule`` JSON file, or an in-memory ``KernelSchedule``.
    The returned hash goes into the engine's bucket keys so work under
    different schedules can never be confused.  A schedule compiled by
    the JAX package (backend ``interpret`` or ``tpu``) is refused with a
    ``ValueError`` that says to recompile it.
    """
    if schedule is None:
        return None, None
    if isinstance(schedule, str):
        from repro_torch.core.precision.compiler import KernelSchedule

        schedule = KernelSchedule.load(schedule)
    if not hasattr(schedule, "fuse_decision"):
        raise TypeError(
            f"schedule= expects a KernelSchedule or a path to one, got "
            f"{type(schedule).__name__}"
        )
    schedule.check_servable()
    return schedule, schedule.hash


def resolve_device(device, engine: str):
    """An engine's device: the CUDA device unless ``device`` says
    otherwise.  Raises when asked for CUDA on a machine without it — there
    is no fallback to the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{engine} runs on the CUDA device unless told otherwise, and no "
            "CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


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
    """Base class for one cached shape.

    Subclasses declare int size fields in display order (batch first) and
    set ``AXES`` to the matching single-letter axis labels, e.g. the VGGT
    bucket ``(batch, frames, patches)`` with axes ``("b", "s", "p")``
    prints as ``b4xs2xp24``.

    Tiered engines add a trailing ``tier: str = "default"`` field — it is
    part of the bucket's identity (each precision tier owns its own
    first uses and stats row) but not an axis: ``sizes()``
    skips it and ``__str__`` prefixes it only for non-default tiers.
    """

    AXES: ClassVar[tuple[str, ...]] = ()

    def sizes(self) -> tuple:
        """The bucket's axis sizes — the *numeric* sort key for stats
        tables (lexical ``str`` sorting would put b16 before b2).  A
        non-default tier (a string) sorts last, grouping tier variants of
        one shape together without perturbing untired buckets."""
        vals = tuple(
            getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "tier"
        )
        tier = getattr(self, "tier", "default")
        return vals if tier == "default" else vals + (tier,)

    def __str__(self) -> str:
        s = "x".join(f"{a}{n}" for a, n in zip(self.AXES, self.sizes()))
        tier = getattr(self, "tier", "default")
        return s if tier == "default" else f"{tier}:{s}"


LATENCY_WINDOW = 1024  # percentile window; totals keep the full history


@dataclasses.dataclass
class BucketStats:
    """Per-bucket serving statistics.

    ``items`` counts the engine's unit of work (scenes for VGGT,
    sequences for the LM engine); ``tokens`` is only used by token
    engines and stays 0 elsewhere.
    """

    compiles: int = 0
    calls: int = 0
    items: int = 0  # real items served
    padded_items: int = 0  # bucket slack (padding waste)
    tokens: int = 0  # decoded/prefilled tokens (LM engines)
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

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.total_s if self.total_s > 0 else 0.0

    # ---- VGGT serving API aliases -------------------------------------
    @property
    def scenes(self) -> int:
        return self.items

    @property
    def padded_scenes(self) -> int:
        return self.padded_items

    @property
    def scenes_per_s(self) -> float:
        return self.items_per_s

    def summary(self) -> dict:
        out = {
            "compiles": self.compiles,
            "calls": self.calls,
            "items": self.items,
            "padded_items": self.padded_items,
            "p50_ms": round(self.p50_ms, 3),
            "p95_ms": round(self.p95_ms, 3),
            "items_per_s": round(self.items_per_s, 2),
        }
        if self.tokens:
            out["tokens"] = self.tokens
            out["tokens_per_s"] = round(self.tokens_per_s, 2)
        return out

    def publish(self, registry: "obs_metrics.Registry", kind: str, bucket: str, tier: str) -> None:
        """Mirror this bucket's running totals into a metrics registry.

        Counters use ``set_total`` (the stats object is the source of
        truth; the registry is a scrape-time view), gauges carry the
        windowed percentiles."""
        lbl = dict(kind=kind, bucket=bucket, tier=tier)
        names = ("kind", "bucket", "tier")
        registry.counter(
            "serve_bucket_compiles_total", "jit compiles per bucket", names
        ).set_total(self.compiles, **lbl)
        registry.counter(
            "serve_bucket_calls_total", "engine forward calls per bucket", names
        ).set_total(self.calls, **lbl)
        registry.counter(
            "serve_bucket_items_total", "real items served per bucket", names
        ).set_total(self.items, **lbl)
        registry.counter(
            "serve_bucket_padded_items_total", "bucket padding slack per bucket", names
        ).set_total(self.padded_items, **lbl)
        registry.counter(
            "serve_bucket_tokens_total", "tokens served per bucket (LM engines)", names
        ).set_total(self.tokens, **lbl)
        registry.counter(
            "serve_bucket_busy_seconds_total", "engine-measured busy seconds per bucket", names
        ).set_total(self.total_s, **lbl)
        registry.gauge(
            "serve_bucket_p50_ms", "windowed p50 call latency (ms)", names
        ).set(self.p50_ms, **lbl)
        registry.gauge(
            "serve_bucket_p95_ms", "windowed p95 call latency (ms)", names
        ).set(self.p95_ms, **lbl)


@dataclasses.dataclass
class SchedulerStats:
    """Admission/eviction counters for a serving scheduler.

    ``admitted_mid_decode`` counts requests that joined a *running*
    decode batch (the continuous-batching win); slot-step counters track
    decode-slot occupancy (``occupied_slot_steps / capacity_slot_steps``
    is the utilization of the compiled decode width).  The robustness
    counters (docs/robustness.md): ``rejected``/``shed`` from admission
    control, ``numeric_faults``/``numeric_retries`` from non-finite-row
    quarantine, ``degraded_admissions`` from the degradation ladder."""

    admitted: int = 0
    admitted_mid_decode: int = 0
    deadline_evictions: int = 0
    occupied_slot_steps: int = 0
    capacity_slot_steps: int = 0
    rejected: int = 0  # admissions refused with QueueFull
    shed: int = 0  # queued requests shed to make room
    numeric_faults: int = 0  # requests quarantined on non-finite rows
    numeric_retries: int = 0  # quarantined requests re-queued at a higher tier
    degraded_admissions: int = 0  # admissions downshifted by the ladder

    @property
    def slot_occupancy(self) -> float:
        if not self.capacity_slot_steps:
            return 0.0
        return self.occupied_slot_steps / self.capacity_slot_steps

    def summary(self) -> dict:
        return {
            "admitted": self.admitted,
            "admitted_mid_decode": self.admitted_mid_decode,
            "deadline_evictions": self.deadline_evictions,
            "slot_occupancy": round(self.slot_occupancy, 4),
            "rejected": self.rejected,
            "shed": self.shed,
            "numeric_faults": self.numeric_faults,
            "numeric_retries": self.numeric_retries,
            "degraded_admissions": self.degraded_admissions,
        }

    def publish(self, registry: "obs_metrics.Registry", kind: str) -> None:
        lbl = dict(kind=kind)
        registry.counter(
            "serve_admitted_total", "requests admitted by the scheduler", ("kind",)
        ).set_total(self.admitted, **lbl)
        registry.counter(
            "serve_admitted_mid_decode_total",
            "requests admitted into a running decode batch",
            ("kind",),
        ).set_total(self.admitted_mid_decode, **lbl)
        registry.counter(
            "serve_deadline_evictions_total", "requests evicted on deadline", ("kind",)
        ).set_total(self.deadline_evictions, **lbl)
        registry.counter(
            "serve_rejected_total", "admissions refused with QueueFull", ("kind",)
        ).set_total(self.rejected, **lbl)
        registry.counter(
            "serve_shed_total", "queued requests shed under overload", ("kind",)
        ).set_total(self.shed, **lbl)
        registry.counter(
            "serve_numeric_faults_total",
            "requests quarantined on non-finite activations",
            ("kind",),
        ).set_total(self.numeric_faults, **lbl)
        registry.counter(
            "serve_numeric_retries_total",
            "quarantined requests retried at a higher tier",
            ("kind",),
        ).set_total(self.numeric_retries, **lbl)
        registry.counter(
            "serve_degraded_admissions_total",
            "admissions downshifted by the degradation ladder",
            ("kind",),
        ).set_total(self.degraded_admissions, **lbl)
        registry.gauge(
            "serve_slot_occupancy", "occupied/capacity decode slot-steps", ("kind",)
        ).set(self.slot_occupancy, **lbl)


class ServeStats:
    """Per-bucket serving statistics container: compiles, latency
    percentiles, throughput.  ``unit`` names the item column in
    ``format()`` ("scenes", "seqs", ...); ``kind`` tags the engine family
    in the unified ``summary()`` schema ("lm", "vggt", ...)."""

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

    @property
    def tokens(self) -> int:
        return sum(s.tokens for s in self.buckets.values())

    @property
    def scenes(self) -> int:  # VGGT serving API alias
        return self.items

    def _sorted(self) -> list[tuple[Bucket, BucketStats]]:
        # numeric shape order — sorting on str(bucket) renders b16 before
        # b2; mixed bucket kinds (prefill vs decode) group by type name
        return sorted(
            self.buckets.items(),
            key=lambda kv: (type(kv[0]).__name__, kv[0].sizes()),
        )

    # ---- measured-latency export (planner feedback) -------------------

    def measured_latency_s(self) -> dict[str, float]:
        """Mean measured seconds per call, per bucket (``str(bucket)``
        keyed) — the serving-side truth the precision planner can
        calibrate its roofline latency model against
        (``core.precision.planner.site_latency_from_stats``)."""
        return {
            str(b): s.total_s / s.calls
            for b, s in self._sorted()
            if s.calls
        }

    def mean_item_latency_s(
        self, warm_only: bool = True, tier: Optional[str] = None
    ) -> float:
        """Measured seconds per served item (the whole-model per-request
        latency a planner budget is about).

        A request passes through each bucket *kind* at most once (LM:
        one PrefillBucket + one DecodeBucket; VGGT: one bucket), so the
        denominator is the per-kind item count — summing across kinds
        would double-count LM requests and halve the latency.

        ``warm_only`` (default) excludes compile-inflated calls: per
        bucket, the ``compiles`` largest entries of the latency window
        are dropped and the warm mean is extrapolated over all calls —
        first-call jit time would otherwise dominate short traces and
        mis-calibrate the planner.  ``tier`` restricts the export to one
        precision tier's buckets (SLA-aware tier autoselection measures
        each tier separately).  Raises when nothing was served.
        """
        rows = [
            (b, s)
            for b, s in self.buckets.items()
            if tier is None or getattr(b, "tier", "default") == tier
        ]
        per_kind: dict[str, int] = {}
        for b, s in rows:
            k = type(b).__name__
            per_kind[k] = per_kind.get(k, 0) + s.items
        items = max(per_kind.values(), default=0)
        if not items:
            raise ValueError("no served traffic to export latencies from")
        total = 0.0
        for _, s in rows:
            lats = list(s.latencies_s)
            if warm_only and s.compiles and len(lats) > s.compiles:
                warm = sorted(lats)[: len(lats) - s.compiles]
                total += sum(warm) / len(warm) * s.calls
            else:
                total += s.total_s
        return total / items

    def summary(self) -> dict:
        """Unified kind-keyed schema shared by every engine family::

            {"kind": "lm" | "vggt" | "generic",
             "unit": "seqs" | "scenes" | ...,
             "totals": {compiles, calls, items, tokens},
             "buckets": {str(bucket): <BucketStats.summary()>},
             "scheduler": {admitted, admitted_mid_decode,
                           deadline_evictions, slot_occupancy,
                           rejected, shed, numeric_faults,
                           numeric_retries, degraded_admissions}}

        Dashboards and ``planner.site_latency_from_stats`` consume one
        format regardless of which engine produced the stats.
        """
        return {
            "kind": self.kind,
            "unit": self.unit,
            "totals": {
                "compiles": self.compiles,
                "calls": self.calls,
                "items": self.items,
                "tokens": self.tokens,
            },
            "buckets": {str(b): s.summary() for b, s in self._sorted()},
            "scheduler": self.scheduler.summary(),
        }

    def publish(self, registry: Optional["obs_metrics.Registry"] = None) -> None:
        """Publish the whole table into a metrics registry (default: the
        process registry).  The ``summary()`` dict and the registry render
        the same underlying totals — the registry is the scrape-time view,
        these objects stay the source of truth."""
        reg = registry if registry is not None else obs_metrics.default()
        kind = self.kind
        for b, s in self._sorted():
            s.publish(reg, kind, str(b), getattr(b, "tier", "default"))
        self.scheduler.publish(reg, kind)
        lbl = dict(kind=kind)
        reg.counter("serve_items_total", "items served", ("kind",)).set_total(self.items, **lbl)
        reg.counter("serve_tokens_total", "tokens served", ("kind",)).set_total(self.tokens, **lbl)
        reg.counter("serve_compiles_total", "jit compiles", ("kind",)).set_total(
            self.compiles, **lbl
        )
        reg.counter("serve_calls_total", "engine forward calls", ("kind",)).set_total(
            self.calls, **lbl
        )

    def format(self) -> str:
        unit = self.unit
        with_tokens = any(s.tokens for s in self.buckets.values())
        hdr = (
            f"{'bucket':>16} {'compiles':>8} {'calls':>6} {unit:>7} "
            f"{'pad':>5} {'p50ms':>8} {'p95ms':>8} {unit + '/s':>9}"
        )
        if with_tokens:
            hdr += f" {'tok/s':>9}"
        lines = [hdr]
        for b, s in self._sorted():
            line = (
                f"{str(b):>16} {s.compiles:>8} {s.calls:>6} {s.items:>7} "
                f"{s.padded_items:>5} {s.p50_ms:>8.1f} {s.p95_ms:>8.1f} "
                f"{s.items_per_s:>9.1f}"
            )
            if with_tokens:
                line += f" {s.tokens_per_s:>9.1f}"
            lines.append(line)
        return "\n".join(lines)


_REQ_IDS = itertools.count(1)  # process-unique request ids for span chains
LOOP_THREAD = "serve-loop"  # the async server's poll loop (``serving.server``)
FLUSH_REASONS = ("full", "deadline", "drain", "sync", "sla", "join")


def emit_flush(reason: str, reqs: list, rows: int) -> None:
    """One ``flush`` span event for a group released to an engine call:
    why (``FLUSH_REASONS``), the rows taken, the oldest request's wait,
    and whether the poll loop or a caller's thread released it."""
    if obs_trace.current() is None:
        return
    obs_trace.emit("flush", reason=reason, rows=rows,
                   wait_s=time.perf_counter() - min(r.t_enqueue for r in reqs),
                   loop=threading.current_thread().name == LOOP_THREAD)


@dataclasses.dataclass
class PendingRequest:
    """Base class for a queued request; ``result()`` is available after
    the engine flushes the request's micro-batch group.

    Engines deliver through ``_deliver``/``_fail`` so a waiter attached
    by the async server (``_event``) is woken exactly when the result
    lands.

    ``priority`` orders admission (higher first; FIFO within a level);
    ``deadline_s`` is a soft SLA in seconds from enqueue — a request
    still unserved at its deadline is evicted with
    :class:`DeadlineExceeded` rather than served late.

    ``req_id`` is a process-unique id labeling this request's span chain
    in ``obs.trace`` — delivery and failure emit the terminal
    complete/evicted/failed events here, so every engine family gets a
    closed chain for free.
    """

    req_id: str = dataclasses.field(
        default_factory=lambda: f"r{next(_REQ_IDS)}", kw_only=True
    )
    priority: int = dataclasses.field(default=0, kw_only=True)
    deadline_s: Optional[float] = dataclasses.field(default=None, kw_only=True)
    t_enqueue: float = dataclasses.field(
        default_factory=time.perf_counter, kw_only=True
    )
    _result: Optional[Any] = dataclasses.field(default=None, kw_only=True)
    _error: Optional[BaseException] = dataclasses.field(default=None, kw_only=True)
    _event: Optional[threading.Event] = dataclasses.field(
        default=None, kw_only=True, repr=False
    )

    @property
    def ready(self) -> bool:
        return self._result is not None or self._error is not None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        return (time.perf_counter() if now is None else now) >= (
            self.t_enqueue + self.deadline_s
        )

    def result(self) -> Any:
        if isinstance(self._error, ServeError):
            # defined serving semantics (deadline miss, shed, numeric
            # quarantine, server stop) surface as the specific class
            raise self._error
        if self._error is not None:
            raise RuntimeError("request's micro-batch failed") from self._error
        if self._result is None:
            raise RuntimeError("request not flushed yet — call engine.flush()")
        return self._result

    def _deliver(self, result: Any) -> None:
        self._result = result
        lat = time.perf_counter() - self.t_enqueue
        obs_trace.emit("complete", request=self.req_id, dur_s=lat)
        if obs_metrics.live():
            obs_metrics.default().histogram(
                "serve_request_latency_seconds",
                "end-to-end request latency (enqueue to delivery)",
            ).observe(lat)
        if self._event is not None:
            self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        phase = "evicted" if isinstance(err, DeadlineExceeded) else "failed"
        obs_trace.emit(
            phase,
            request=self.req_id,
            dur_s=time.perf_counter() - self.t_enqueue,
            error=type(err).__name__,
        )
        if self._event is not None:
            self._event.set()


class MicroBatchQueue:
    """Per-group pending-request queues with ``max_batch`` coalescing and
    deadline flushing.

    ``run(group_key, requests)`` is the engine's flush callback: it must
    execute the coalesced requests and ``_deliver`` each one's result.
    ``add`` auto-flushes a group the moment it reaches ``max_batch``
    items; ``poll`` flushes groups whose oldest request has waited past
    ``max_wait_s`` (the async server drives this on a timer).  Each
    release emits a ``flush`` event (``emit_flush``) with its reason.
    """

    def __init__(
        self,
        run: Callable[[Hashable, list[PendingRequest]], None],
        max_batch: int,
        max_wait_s: float,
    ):
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
            self.flush_group(key, "full")
        return req

    def poll(self) -> int:
        """Flush groups whose oldest request has waited past the deadline.
        Returns the number of groups flushed."""
        now = time.perf_counter()
        due = [
            key
            for key, q in self._queues.items()
            if q and now - q[0][0].t_enqueue >= self.max_wait_s
        ]
        for key in due:
            self.flush_group(key, "deadline")
        return len(due)

    def flush(self) -> None:
        """Flush every pending group."""
        for key in [k for k, q in self._queues.items() if q]:
            self.flush_group(key, "drain")

    def evict_expired(
        self, now: Optional[float] = None, stats: Optional[SchedulerStats] = None
    ) -> int:
        """Fail queued requests whose ``deadline_s`` already passed with
        :class:`DeadlineExceeded` (deadline-ordered admission's other
        half: a request that can no longer be served in time is evicted,
        not served late).  Returns the eviction count."""
        now = time.perf_counter() if now is None else now
        n = 0
        for q in self._queues.values():
            for r, _ in [e for e in q if e[0].expired(now)]:
                r._fail(
                    DeadlineExceeded(
                        f"request missed its {r.deadline_s:.3f}s deadline "
                        "while queued"
                    )
                )
                n += 1
            q[:] = [e for e in q if not e[0].ready]
        if stats is not None:
            stats.deadline_evictions += n
        return n

    def remove(self, req: PendingRequest) -> bool:
        """Drop one queued request without failing or running it (the
        caller owns delivery — admission shedding fails it with
        :class:`QueueFull`).  Returns False when the request is not
        queued (already flushed or never added)."""
        for q in self._queues.values():
            for i, (r, _) in enumerate(q):
                if r is req:
                    del q[i]
                    return True
        return False

    def fail_pending(self, err: BaseException) -> int:
        """Fail every queued request without running it (server shutdown
        without drain) so waiters wake with an error instead of blocking
        on a request that will never be served.  Returns the count."""
        n = 0
        for q in self._queues.values():
            for r, _ in q:
                r._fail(err)
                n += 1
            q.clear()
        return n

    def flush_group(self, key: Hashable, reason: str = "sync") -> None:
        """Run the group's queued requests, ``max_batch`` items a call;
        ``reason`` is why (``FLUSH_REASONS``; "sync": a caller waits for
        one request)."""
        q = self._queues.get(key, [])
        # priority-ordered admission: higher priority first, FIFO within a
        # level (stable sort on enqueue order keeps coalescing fair)
        if any(r.priority for r, _ in q):
            q.sort(key=lambda e: (-e[0].priority, e[0].t_enqueue))
        while q:
            # take requests up to max_batch items (an oversize request
            # runs alone in its own exact-size bucket)
            take, n = [], 0
            while q and (not take or n + q[0][1] <= self.max_batch):
                r, s = q.pop(0)
                take.append(r)
                n += s
            emit_flush(reason, take, n)
            try:
                self._run(key, take)
            except Exception as e:
                # deliver the failure to every coalesced owner instead of
                # leaving popped requests forever un-ready
                for r in take:
                    if not r.ready:
                        r._fail(e)
                raise


# ---------------------------------------------------------------------------
# robustness: admission control + degradation ladder (docs/robustness.md)
# ---------------------------------------------------------------------------


def _shed_key(r: PendingRequest) -> tuple:
    """Shed preference (min sheds first): lowest priority, then latest
    effective deadline (no deadline = no SLA = least urgent), then
    newest arrival."""
    dl = r.t_enqueue + r.deadline_s if r.deadline_s is not None else float("inf")
    return (r.priority, -dl, -r.t_enqueue)


class AdmissionController:
    """Bounded pending queue shared by both engines.

    ``max_pending`` caps queued *requests*, ``max_queued_tokens`` caps
    the engine-defined work size summed over the queue (LM: prompt +
    generation tokens; VGGT: patch tokens).  ``policy="reject"`` raises
    :class:`QueueFull` at ``enqueue``; ``policy="shed"`` instead evicts
    the least-valuable queued requests (:func:`_shed_key` order) to make
    room — the incoming request is still rejected when it sheds below
    everything already queued.  Unbounded (both caps None) is free."""

    def __init__(
        self,
        max_pending: Optional[int] = None,
        max_queued_tokens: Optional[int] = None,
        policy: str = "reject",
    ):
        if policy not in ("reject", "shed"):
            raise ValueError(f"admission policy {policy!r}: expected reject | shed")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self.max_queued_tokens = max_queued_tokens
        self.policy = policy

    @property
    def bounded(self) -> bool:
        return self.max_pending is not None or self.max_queued_tokens is not None

    def check(
        self,
        req: PendingRequest,
        pending: list,
        size_of: Callable[[PendingRequest], int],
        stats: SchedulerStats,
    ) -> list:
        """Admission decision for ``req`` against the queued ``pending``
        requests (``req`` not yet among them).  Returns the victims the
        engine must shed (fail with :class:`QueueFull` + drop from its
        queue); raises :class:`QueueFull` when the incoming request is
        the one to refuse."""
        if not self.bounded:
            return []
        live = list(pending)
        victims: list = []

        def over() -> bool:
            if self.max_pending is not None and len(live) + 1 > self.max_pending:
                return True
            if self.max_queued_tokens is not None:
                toks = size_of(req) + sum(size_of(q) for q in live)
                if toks > self.max_queued_tokens:
                    return True
            return False

        while over():
            victim = min(live + [req], key=_shed_key) if live else req
            if self.policy == "reject" or victim is req:
                stats.rejected += 1
                raise QueueFull(
                    f"admission rejected: {len(live)} queued requests "
                    f"(max_pending={self.max_pending}, "
                    f"max_queued_tokens={self.max_queued_tokens}, "
                    f"policy={self.policy})"
                )
            live.remove(victim)
            victims.append(victim)
            stats.shed += 1
        return victims


@dataclasses.dataclass
class DegradeConfig:
    """Thresholds for the graceful degradation ladder.

    Pressure = queue depth above ``queue_high`` or measured per-request
    latency above ``latency_high_s``; sustained pressure (``dwell_s``)
    downshifts one level.  Recovery needs the *low* watermarks to hold
    for ``recover_s`` (hysteresis: the recover dwell is longer than the
    downshift dwell by default, so the ladder does not oscillate)."""

    queue_high: int = 8
    queue_low: Optional[int] = None  # default: queue_high // 2
    latency_high_s: Optional[float] = None  # latency pressure off unless set
    latency_low_s: Optional[float] = None  # default: 0.5 * latency_high_s
    dwell_s: float = 0.05
    recover_s: float = 0.25
    max_level: Optional[int] = None  # default: number of tiers - 1


class DegradationController:
    """Graceful degradation ladder over an engine's declared tiers.

    Declaration order is quality preference (docs/serving.md), so level
    N maps an admission's resolved tier N steps toward the *last*
    (cheapest) declared tier.  ``observe`` is fed queue depth + measured
    ``mean_item_latency_s`` on every enqueue/poll; shifts need the
    condition to hold for the configured dwell, giving hysteresis in
    both directions.  Explicitly pinned tiers are never downshifted —
    the ladder only steers default/"auto" admissions."""

    def __init__(self, cfg: Optional[DegradeConfig], n_tiers: int):
        self.cfg = cfg if cfg is not None else DegradeConfig()
        cap = self.cfg.max_level
        self.max_level = max(n_tiers - 1, 0) if cap is None else min(cap, max(n_tiers - 1, 0))
        self.level = 0
        self.shifts_down = 0
        self.shifts_up = 0
        self._pressure_since: Optional[float] = None
        self._relief_since: Optional[float] = None

    def observe(
        self, pending: int, latency_s: Optional[float], now: Optional[float] = None
    ) -> int:
        """Feed one load sample; returns the (possibly shifted) level."""
        c = self.cfg
        now = time.perf_counter() if now is None else now
        q_low = c.queue_low if c.queue_low is not None else c.queue_high // 2
        l_low = (
            c.latency_low_s
            if c.latency_low_s is not None
            else (0.5 * c.latency_high_s if c.latency_high_s is not None else None)
        )
        pressure = pending > c.queue_high or (
            c.latency_high_s is not None
            and latency_s is not None
            and latency_s > c.latency_high_s
        )
        relief = pending <= q_low and (
            l_low is None or latency_s is None or latency_s <= l_low
        )
        if pressure:
            self._relief_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            if now - self._pressure_since >= c.dwell_s and self.level < self.max_level:
                self.level += 1
                self.shifts_down += 1
                self._pressure_since = None  # re-arm: next shift needs a fresh dwell
        elif relief:
            self._pressure_since = None
            if self.level == 0:
                self._relief_since = None
            else:
                if self._relief_since is None:
                    self._relief_since = now
                if now - self._relief_since >= c.recover_s:
                    self.level -= 1
                    self.shifts_up += 1
                    self._relief_since = None
        else:  # between the watermarks: hold the level, reset both dwells
            self._pressure_since = None
            self._relief_since = None
        return self.level
