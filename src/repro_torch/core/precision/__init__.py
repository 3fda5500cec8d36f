"""Reconfigurable mixed-precision subsystem (paper §IV "versatile
quantization" made per-layer; port of ``repro/core/precision``).

The paper's accelerator runs BF16, INT8, and INT4 *side by side*:
precision-sensitive operators stay high precision while the bulk of the
network runs 4-bit.  This package is the software realization:

* ``plan``    — the policy model: named weight sites (per-block attention
  qkv/o, ffn projections) mapped to one of the precision levels
  ``bf16 | w8a8 | w4a8 | w4a4`` via glob-style overrides, with JSON
  serialization (:class:`PrecisionPlan`, :class:`LayerPolicy`).
* ``planner`` — a calibration-free sensitivity planner: each site is
  scored by quantization error on synthetic saturated-channel
  activations pushed through the site's orthogonal transform (the
  paper's scene-agnostic premise), then bits are assigned greedily under
  a modeled weight-bytes + latency budget (``launch/roofline_util``: the
  H100's int8 rate and HBM bandwidth).
* ``compiler`` — lowers ``(model config, PrecisionPlan)`` to an explicit,
  JSON-serializable :class:`KernelSchedule`: one entry per weight site
  with kernel choice, launch tiles, prologue/epilogue descriptors, and
  fallback reasons.  The engine loads the schedule instead of
  re-deciding fusion at quantize time.
* ``tuner``   — autotuner behind the compiler: costs each kernel's
  launch tiles (modeled HBM bytes on the CPU, CUDA-event time on the
  card) and persists winners in a :class:`TuningDB` keyed on (kernel,
  shape, bits, fusion, backend).

Dispatch lives in ``core/model_quant``: ``quantize_vggt`` and
``quantize_lm`` accept a :class:`PrecisionPlan` or a
:class:`KernelSchedule` wherever they accept a uniform ``QuantPolicy``,
and emit per-site ``QuantLinear`` leaves (the int8 kernel path, the
packed-int4 path, or a transform-fused float passthrough).  The planner
and the compiler walk VGGT and every LM of the registry (GQA and MLA
attention, Mamba and rwkv mixers with dense, MoE and rwkv channel-mix
FFNs).
"""
from repro_torch.core.precision.plan import (
    LEVELS,
    LayerPolicy,
    PrecisionPlan,
    level_policy,
    parse_level,
)
from repro_torch.core.precision.compiler import (
    AttentionSchedule,
    FusedGroupSchedule,
    KernelSchedule,
    SiteSchedule,
    compile_schedule,
)
from repro_torch.core.precision.tuner import Autotuner, TuningDB
from repro_torch.core.precision.planner import (
    SiteInfo,
    enumerate_sites,
    plan_model,
    proxy_recon_error,
    score_sites,
    site_latency_from_stats,
    uniform_weight_bytes,
)

__all__ = [
    "AttentionSchedule",
    "Autotuner",
    "FusedGroupSchedule",
    "KernelSchedule",
    "SiteSchedule",
    "TuningDB",
    "compile_schedule",
    "LEVELS",
    "LayerPolicy",
    "PrecisionPlan",
    "level_policy",
    "parse_level",
    "SiteInfo",
    "enumerate_sites",
    "plan_model",
    "proxy_recon_error",
    "score_sites",
    "site_latency_from_stats",
    "uniform_weight_bytes",
]
