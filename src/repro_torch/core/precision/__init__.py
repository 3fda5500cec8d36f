"""Per-site mixed precision (the plan model; planner, compiler and tuner
are not ported yet)."""
from repro_torch.core.precision.plan import (
    LEVELS,
    LayerPolicy,
    PrecisionPlan,
    level_policy,
    parse_level,
)

__all__ = ["LEVELS", "LayerPolicy", "PrecisionPlan", "level_policy", "parse_level"]
