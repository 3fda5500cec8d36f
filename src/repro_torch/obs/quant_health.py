"""In-path quantization-health monitors (port of
``repro/obs/quant_health.py``).

VersaQ-3D's failure mode is silent: a minority of saturated activation
channels (the outlier pathology Fig. 1/4 measures) eats the low-bit
dynamic range and accuracy degrades with no crash to point at.  These
monitors watch the serve-time quantize path and attribute three cheap
signals to `PrecisionPlan` site paths:

* **clip rate** — fraction of elements landing in the extreme quant bin
  (|q| == qmax).  Per-token dynamic scales mean nothing is ever clipped
  *off*, so a high extreme-bin fraction is the live proxy for "one
  outlier channel owns the scale".
* **scale crest** — mean per-token crest factor amax/rms.  High crest =
  the scale is set by a spike far above the typical magnitude, i.e. most
  of the quant grid is wasted (scale saturation).
* **overflow** — count of |round(x/scale)| > qmax before clamping.  With
  symmetric amax scales this is the rounding-edge case at exactly amax;
  a nonzero rate on the packed-int4 path flags values that would wrap if
  the clamp were ever dropped.

Monitoring is OFF by default and costs nothing when off (`monitor()`
returns after one check).  When on, every call is counted per site on
the host and only every `every`-th call (the 0th, `every`-th, ...) computes
the statistics: a few reductions on the tensor's device, read back with
one `.tolist()` (one device sync per sample).  The calls sampled are the
reference's, which counts in its host sink the same way.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from repro_torch.core.quantize import int_range
from repro_torch.obs import metrics as obs_metrics

_lock = threading.Lock()
_cfg: Dict[str, object] = {"every": 0, "registry": None}
_calls: Dict[str, int] = {}


def enable(every: int = 16, registry: Optional[obs_metrics.Registry] = None) -> None:
    """Turn monitors on, sampling every `every`-th call per site."""
    if every < 1:
        raise ValueError("every must be >= 1")
    with _lock:
        _cfg["every"] = int(every)
        _cfg["registry"] = registry
        _calls.clear()


def disable() -> None:
    with _lock:
        _cfg["every"] = 0
        _cfg["registry"] = None
        _calls.clear()


def enabled() -> bool:
    return _cfg["every"] > 0  # type: ignore[operator]


def _registry() -> obs_metrics.Registry:
    reg = _cfg["registry"]
    return reg if isinstance(reg, obs_metrics.Registry) else obs_metrics.default()


def _sampled(site: str) -> bool:
    """Count one call of ``site``; True when this call is sampled."""
    every = _cfg["every"]
    if not every:
        return False
    with _lock:
        n = _calls.get(site, 0)
        _calls[site] = n + 1
    return n % int(every) == 0  # type: ignore[arg-type]


def _observe(site: str, a_bits: int, clip_frac: float, crest: float, overflow: float) -> None:
    reg = _registry()
    lbl = dict(site=site, a_bits=str(a_bits))
    reg.gauge(
        "quant_clip_rate", "Fraction of activations in the extreme quant bin", ("site", "a_bits")
    ).set(clip_frac, **lbl)
    reg.gauge(
        "quant_scale_crest", "Mean per-token crest factor amax/rms of quantized activations",
        ("site", "a_bits"),
    ).set(crest, **lbl)
    reg.counter(
        "quant_overflow_total", "Pre-clamp |round(x/scale)| > qmax occurrences", ("site", "a_bits")
    ).inc(overflow, **lbl)
    reg.counter(
        "quant_health_samples_total", "Quant-health samples recorded", ("site", "a_bits")
    ).inc(1.0, **lbl)


def stats(x: torch.Tensor, a_bits: int) -> torch.Tensor:
    """[clip_frac, crest, overflow] (float64, on x's device) by the
    quantizer's own scale rule (symmetric per-token amax / qmax)."""
    qmax = float(int_range(int(a_bits))[1])
    xf = x.to(torch.float32).abs()
    amax = xf.amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.round(xf / scale)
    clip_frac = (q >= qmax).to(torch.float32).mean()
    overflow = (q > qmax).sum()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True))
    crest = torch.mean(amax / (rms + 1e-8))
    return torch.stack([clip_frac.double(), crest.double(), overflow.double()])


def monitor(site: Optional[str], x: torch.Tensor, a_bits: int) -> None:
    """Observe the activation tensor a site is about to quantize; emits
    nothing when monitoring is off, the site is unnamed, or this call is
    not sampled."""
    if site is None or not enabled() or not _sampled(str(site)):
        return
    clip_frac, crest, overflow = stats(x, a_bits).tolist()
    _observe(str(site), int(a_bits), clip_frac, crest, overflow)


def sites_sampled() -> Dict[str, int]:
    """Host-side call counts per site (mostly for tests/diagnostics)."""
    with _lock:
        return dict(_calls)
