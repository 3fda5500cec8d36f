"""Dependency-free metrics registry: counters, gauges, histograms (the
port's own copy of ``repro/obs/metrics.py``; same families, same text).

The serving stats objects (`serving.batching.ServeStats` et al.) publish
into a `Registry` at scrape time, the kernel probe and quant-health
monitors write into it directly, and two renderers expose one coherent
view: Prometheus text exposition (`render_prometheus`) and a JSON dump
(`render_json`).  Nothing here imports torch or anything outside the
stdlib — the registry must stay importable from every layer of the
stack without creating cycles.

Metric families are identified by (name, kind, label names); a family
holds one series per distinct label-value tuple.  Creation is
get-or-create so call sites can re-declare a family idempotently:

    REG = metrics.default()
    REG.counter("requests_total", "Requests seen", ("kind",)).inc(kind="lm")
    REG.gauge("slot_occupancy", "Occupied/capacity").set(0.8)
    REG.histogram("latency_seconds", "E2E latency", ("kind",)).observe(0.02, kind="lm")

Registered *collectors* (callables taking the registry) run at render
time so pull-style sources — engine stats, probe counters — refresh
lazily instead of instrumenting their hot paths.
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default latency buckets (seconds) — spans the CPU path (slow) down to
# on-card step times; +Inf is implicit.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

LabelValues = Tuple[str, ...]


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _check_labels(label_names: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(label_names)
    for ln in names:
        if not _LABEL_RE.match(ln):
            raise ValueError(f"invalid label name {ln!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate label names {names!r}")
    return names


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class Metric:
    """Base family: name, help text, declared label names, series map."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.label_names = _check_labels(label_names)
        self._series: Dict[LabelValues, object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> LabelValues:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {tuple(labels)}"
            )
        return tuple(str(labels[ln]) for ln in self.label_names)

    def series(self) -> Dict[LabelValues, object]:
        with self._lock:
            return dict(self._series)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(Metric):
    """Monotone counter.  `inc` adds; `set_total` overwrites (for publish-
    style sources that already track a running total)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, total: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(total)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


@dataclass
class _HistSeries:
    counts: List[int]
    total: float = 0.0
    n: int = 0


class Histogram(Metric):
    """Fixed-bucket histogram; bucket bounds are upper edges, +Inf implicit."""

    kind = "histogram"

    def __init__(self, name, help, label_names=(), buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, label_names)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: histogram buckets must be strictly increasing")
        self.buckets = bounds

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(counts=[0] * (len(self.buckets) + 1))
            i = len(self.buckets)
            for j, edge in enumerate(self.buckets):
                if v <= edge:
                    i = j
                    break
            s.counts[i] += 1
            s.total += v
            s.n += 1

    def count(self, **labels: str) -> int:
        with self._lock:
            s = self._series.get(self._key(labels))
            return 0 if s is None else s.n


class Registry:
    """Holds metric families plus render-time collectors."""

    def __init__(self) -> None:
        self._families: Dict[str, Metric] = {}
        self._collectors: List[Callable[["Registry"], None]] = []
        self._lock = threading.Lock()

    # -- family get-or-create ------------------------------------------------
    def _get(self, cls, name, help, label_names, **kw) -> Metric:
        with self._lock:
            m = self._families.get(name)
            if m is None:
                m = cls(name, help, label_names, **kw)
                self._families[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(f"{name}: registered as {m.kind}, requested {cls.kind}")
        if m.label_names != _check_labels(label_names):
            raise ValueError(
                f"{name}: registered with labels {m.label_names}, requested {tuple(label_names)}"
            )
        return m

    def counter(self, name: str, help: str = "", label_names: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "", label_names: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, label_names)

    def histogram(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, label_names, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[Metric]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    # -- collectors ----------------------------------------------------------
    def register_collector(self, fn: Callable[["Registry"], None]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[["Registry"], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)

    # -- renderers -----------------------------------------------------------
    def render_prometheus(self, collect: bool = True) -> str:
        if collect:
            self.collect()
        out: List[str] = []
        for m in self.families():
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(m.series().items()):
                base = list(zip(m.label_names, key))
                if isinstance(m, Histogram):
                    assert isinstance(val, _HistSeries)
                    cum = 0
                    for edge, c in zip(m.buckets + (float("inf"),), val.counts):
                        cum += c
                        lbl = _render_labels(base + [("le", _fmt_value(edge))])
                        out.append(f"{m.name}_bucket{lbl} {cum}")
                    lbl = _render_labels(base)
                    out.append(f"{m.name}_sum{lbl} {_fmt_value(val.total)}")
                    out.append(f"{m.name}_count{lbl} {val.n}")
                else:
                    out.append(f"{m.name}{_render_labels(base)} {_fmt_value(float(val))}")
        return "\n".join(out) + "\n"

    def render_json(self, collect: bool = True) -> dict:
        if collect:
            self.collect()
        fams = {}
        for m in self.families():
            series = []
            for key, val in sorted(m.series().items()):
                labels = dict(zip(m.label_names, key))
                if isinstance(m, Histogram):
                    assert isinstance(val, _HistSeries)
                    series.append(
                        {
                            "labels": labels,
                            "buckets": list(m.buckets),
                            "counts": list(val.counts),
                            "sum": val.total,
                            "count": val.n,
                        }
                    )
                else:
                    series.append({"labels": labels, "value": float(val)})
            fams[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return fams

    def render_json_text(self, collect: bool = True) -> str:
        return json.dumps(self.render_json(collect=collect), indent=2, sort_keys=True)


def _render_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


# -- process-default registry + live-instrumentation flag --------------------

_DEFAULT = Registry()
_live = False


def default() -> Registry:
    """The process-wide registry: probe counters, quant health and the
    serving HTTP endpoints all meet here unless told otherwise."""
    return _DEFAULT


def set_live(on: bool) -> None:
    """Toggle inline instrumentation (e.g. per-request latency histograms
    observed from the serving hot path).  Off by default so un-telemetered
    runs pay nothing."""
    global _live
    _live = bool(on)


def live() -> bool:
    return _live


def export_kernel_counters(
    registry: Registry,
    counts: Dict[str, int],
    nbytes: Dict[str, int],
    help_suffix: str = "",
) -> None:
    """Publish kernel-probe launch counts + modeled HBM bytes as counters."""
    c = registry.counter(
        "kernel_launches_total",
        "Hand-written kernel launches recorded by their wrappers" + help_suffix,
        ("kernel",),
    )
    b = registry.counter(
        "kernel_modeled_hbm_bytes_total",
        "Bytes each kernel's function moves (inputs read once, outputs written once)"
        + help_suffix,
        ("kernel",),
    )
    for name, n in counts.items():
        c.set_total(n, kernel=name)
    for name, nb in nbytes.items():
        b.set_total(nb, kernel=name)
