"""Hardware constants of the card the port targets (the part of
``repro/launch/roofline_util.py`` the precision planner needs).

NVIDIA H100 SXM 80 GB, dense peaks from NVIDIA's data sheet:

* ``PEAK_FLOPS`` — the int8 tensor-core rate, 1,979 TOP/s.  The
  planner's ``_rate_multiplier`` normalizes every level to this INT8 mode.
* ``HBM_BW`` — HBM3 bandwidth, 3.35 TB/s.

``chip_smoke.py`` reads its int8 and byte bounds from here too.  The
reference module's dry-run HLO parsing waits for the multi-device port
(``ROADMAP.md``, queue 1 item 11).
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BW"]

PEAK_FLOPS = 1979e12  # int8 dense tensor-core operations per second
HBM_BW = 3.35e12  # bytes/s
