"""Kernel-launch accounting probe (port of ``repro/kernels/probe.py``).

Every hand-written CUDA kernel records one launch here at the point where
it is launched, and nowhere else: the plain PyTorch versions that CPU
tensors take record nothing.  Tests, benchmarks and ``chip_smoke.py``
read the counts to show that a path really went through the kernels.

Each record may carry ``nbytes``: the bytes the kernel's function moves
(each input read once, each output written once), the byte count behind
the kernel's bound in ``PERF.md``, not the traffic of the kernel's own
tiling.

Two sinks:

* ``tracking()`` — scoped ``KernelCallLog``.  Contexts nest; ``record()``
  fans out to every active log, so an inner scope never hides launches
  from the enclosing one.
* ``enable_global()`` — an always-on aggregate ``KernelCounters`` (dicts,
  not per-call lists, so it is safe to leave running under serving
  traffic).  The telemetry registry scrapes it per kernel name.
"""
from __future__ import annotations

import contextlib
from typing import Optional

__all__ = [
    "KernelCallLog",
    "KernelCounters",
    "tracking",
    "record",
    "enable_global",
    "disable_global",
    "global_counters",
]


class KernelCallLog:
    """Ordered record of kernel launches seen while ``tracking`` is live,
    with the bytes each kernel's launches moved."""

    def __init__(self) -> None:
        self.calls: list[str] = []
        self.nbytes: dict[str, int] = {}

    @property
    def count(self) -> int:
        return len(self.calls)

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes.values())

    def by_name(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name in self.calls:
            out[name] = out.get(name, 0) + 1
        return out

    def reset(self) -> None:
        self.calls.clear()
        self.nbytes.clear()


class KernelCounters:
    """Aggregate launch counts + bytes per kernel name; O(1) per record
    and bounded in memory — the shape the always-on telemetry needs."""

    def __init__(self) -> None:
        self.counts: dict[str, int] = {}
        self.nbytes: dict[str, int] = {}

    def record(self, name: str, n: int = 1, nbytes: int = 0) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)
        if nbytes:
            self.nbytes[name] = self.nbytes.get(name, 0) + int(nbytes)

    @property
    def count(self) -> int:
        return sum(self.counts.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes.values())

    def by_name(self) -> dict[str, int]:
        return dict(self.counts)

    def reset(self) -> None:
        self.counts.clear()
        self.nbytes.clear()


_active: list[KernelCallLog] = []  # record() fans out to every active log
_global: Optional[KernelCounters] = None


@contextlib.contextmanager
def tracking():
    """Collect kernel-launch records; nests (all active logs record)."""
    log = KernelCallLog()
    _active.append(log)
    try:
        yield log
    finally:
        _active.remove(log)


def record(name: str, n: int = 1, nbytes: int = 0) -> None:
    """Record ``n`` kernel launches attributed to ``name`` and the bytes
    they move in every active ``tracking`` log and in the global counters
    when enabled; no-op otherwise."""
    for log in _active:
        log.calls.extend([name] * n)
        if nbytes:
            log.nbytes[name] = log.nbytes.get(name, 0) + int(nbytes)
    g = _global
    if g is not None:
        g.record(name, n, nbytes)


def enable_global() -> KernelCounters:
    """Turn on the always-on aggregate sink; returns it (existing counters
    are kept if already enabled)."""
    global _global
    if _global is None:
        _global = KernelCounters()
    return _global


def disable_global() -> None:
    global _global
    _global = None


def global_counters() -> Optional[KernelCounters]:
    return _global
