"""Unified telemetry for the serving stack (port of ``repro/obs``).

Three pillars, each usable alone:

* `obs.metrics`  — dependency-free Counter/Gauge/Histogram registry with
  Prometheus-text and JSON renderers (`docs/observability.md` inventories
  the exported families).
* `obs.trace`    — per-request span events (enqueue → admit → forward →
  complete/evicted/failed) with a ring buffer + optional JSONL mirror.
* `obs.quant_health` — sampled in-path monitors for the low-bit
  activation pathology (clip rate / scale crest / overflow) per
  `PrecisionPlan` site.

`enable_all()` flips everything on for a serving process (AsyncServer
calls it when started with a metrics port); `disable_all()` restores the
zero-overhead default.  The kernel probe's global counters are bridged
into the registry by a render-time collector, so `/metrics` always shows
current launch totals without the probe knowing about Prometheus.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels import probe
from repro_torch.obs import metrics, quant_health, trace

__all__ = [
    "metrics",
    "trace",
    "quant_health",
    "enable_all",
    "disable_all",
    "enabled",
    "kernel_counter_collector",
]


def kernel_counter_collector(registry: metrics.Registry) -> None:
    """Render-time collector: mirror the probe's global counters into the
    registry (no-op until `probe.enable_global()` has run)."""
    g = probe.global_counters()
    if g is not None:
        metrics.export_kernel_counters(registry, g.counts, g.nbytes)


_enabled = False


def enabled() -> bool:
    return _enabled


def enable_all(
    registry: Optional[metrics.Registry] = None,
    trace_capacity: int = 2048,
    trace_path: Optional[str] = None,
    quant_every: int = 64,
) -> trace.Tracer:
    """Turn on live telemetry: inline metrics, span tracing, always-on
    kernel counters, and sampled quant-health monitors.

    Idempotent; a tracer already installed is kept unless `trace_path`
    asks for a JSONL mirror it doesn't have.  Returns the active tracer.
    """
    global _enabled
    reg = registry or metrics.default()
    metrics.set_live(True)
    probe.enable_global()
    reg.register_collector(kernel_counter_collector)
    quant_health.enable(every=quant_every, registry=registry)
    tr = trace.current()
    if tr is None or (trace_path is not None and tr.jsonl_path != trace_path):
        tr = trace.Tracer(capacity=trace_capacity, jsonl_path=trace_path)
        trace.install(tr)
    _enabled = True
    return tr


def disable_all(registry: Optional[metrics.Registry] = None) -> None:
    """Back to the zero-overhead default."""
    global _enabled
    reg = registry or metrics.default()
    metrics.set_live(False)
    quant_health.disable()
    probe.disable_global()
    reg.unregister_collector(kernel_counter_collector)
    tr = trace.uninstall()
    if tr is not None:
        tr.close()
    _enabled = False
