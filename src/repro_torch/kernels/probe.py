"""Kernel-launch accounting probe (port of ``repro/kernels/probe.py``).

Every hand-written CUDA kernel records one launch here at the point where
it is launched, and nowhere else: the plain PyTorch versions that CPU
tensors take record nothing.  Tests, benchmarks and ``chip_smoke.py``
read the counts to show that a path really went through the kernels.

``tracking()`` yields a scoped ``KernelCallLog``.  Contexts nest;
``record()`` fans out to every active log, so an inner scope never hides
launches from the enclosing one.
"""
from __future__ import annotations

import contextlib

__all__ = ["KernelCallLog", "tracking", "record"]


class KernelCallLog:
    """Ordered record of kernel launches seen while ``tracking`` is live."""

    def __init__(self) -> None:
        self.calls: list[str] = []

    @property
    def count(self) -> int:
        return len(self.calls)

    def by_name(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name in self.calls:
            out[name] = out.get(name, 0) + 1
        return out


_active: list[KernelCallLog] = []  # record() fans out to every active log


@contextlib.contextmanager
def tracking():
    """Collect kernel-launch records; nests (all active logs record)."""
    log = KernelCallLog()
    _active.append(log)
    try:
        yield log
    finally:
        _active.remove(log)


def record(name: str, n: int = 1) -> None:
    """Record ``n`` kernel launches attributed to ``name`` in every active
    ``tracking`` log; no-op when none is active."""
    for log in _active:
        log.calls.extend([name] * n)
