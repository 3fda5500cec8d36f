"""Serving-precision specs (port of the serving part of
``repro/launch/specs.py``: ``SERVE_SPEC_GRAMMAR`` and ``ServeSpec``).

The reference module also holds the dry-run's (arch x shape) cells and
the LM, training and sharding specs; those wait for the port of their
own paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig

__all__ = ["SERVE_SPEC_GRAMMAR", "ServeSpec"]

SERVE_SPEC_GRAMMAR = (
    "fp | w<bits>a<bits>[:fused] | plan[:fused] | schedule=<path> "
    "(e.g. fp, w4a8, w4a16, w4a8:fused, plan, plan:fused, "
    "schedule=out/lm.schedule.json)"
)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One parsed serving-precision spec (the ``--policy`` / ``--tiers``
    value grammar: ``SERVE_SPEC_GRAMMAR``).

    ``parse``/``format`` round-trip exactly, malformed input raises one
    informative ``ValueError``, and ``materialize`` turns the spec into
    what the engine takes — ``None`` (full precision), a
    ``PrecisionPlan`` (uniform, ``:fused`` or the sensitivity planner's
    mixed plan) or a compiled ``KernelSchedule``.

        ServeSpec.parse("w4a8:fused").materialize(cfg, params)
        ServeSpec.parse_tiers("quality=fp,fast=plan:fused")  # name -> ServeSpec
    """

    level: str  # "fp" | "w<bits>a<bits>" | "plan" | "schedule"
    fused: bool = False
    method: str = "versaq"
    path: Optional[str] = None  # schedule file (level == "schedule" only)

    @classmethod
    def parse(cls, s: str, method: str = "versaq") -> "ServeSpec":
        from repro_torch.core.precision.plan import parse_level

        raw = s
        stripped = s.strip()
        # the path operand is case-sensitive — match the key before lowercasing
        if stripped.lower().startswith("schedule="):
            path = stripped[len("schedule="):]
            if not path:
                raise ValueError(
                    f"serve spec {raw!r}: schedule= needs a file path; "
                    f"expected {SERVE_SPEC_GRAMMAR}"
                )
            return cls(level="schedule", method=method, path=path)
        s = stripped.lower()
        base, _, suffix = s.partition(":")
        if suffix and suffix != "fused":
            raise ValueError(
                f"serve spec {raw!r}: unknown suffix {suffix!r} (only ':fused'); "
                f"expected {SERVE_SPEC_GRAMMAR}"
            )
        fused = suffix == "fused"
        if base in ("fp", "bf16"):
            if fused:
                raise ValueError(f"serve spec {raw!r}: nothing to fuse at full precision")
            return cls(level="fp", method=method)
        if base == "plan":
            return cls(level="plan", fused=fused, method=method)
        try:
            if parse_level(base) is None:  # only w<bits>a<bits> reaches here
                raise ValueError(base)
        except ValueError as e:
            raise ValueError(f"serve spec {raw!r}: expected {SERVE_SPEC_GRAMMAR}") from e
        return cls(level=base, fused=fused, method=method)

    def format(self) -> str:
        """The canonical string form; ``parse(format()) == self``."""
        if self.level == "schedule":
            return f"schedule={self.path}"
        return self.level + (":fused" if self.fused else "")

    def __str__(self) -> str:
        return self.format()

    # -- tier maps ("name=spec,name=spec") --------------------------------

    @classmethod
    def parse_tiers(
        cls, s: Optional[str], method: str = "versaq"
    ) -> Optional[dict[str, "ServeSpec"]]:
        """Parse ``name=spec[,name=spec...]`` into an ordered tier map
        (None for empty input — the single-policy path)."""
        if not s:
            return None
        tiers: dict[str, ServeSpec] = {}
        for part in s.split(","):
            name, eq, spec = part.partition("=")
            name, spec = name.strip(), spec.strip()
            if not eq or not name or not spec:
                raise ValueError(
                    f"tiers entry {part.strip()!r}: expected name=spec with "
                    f"spec in {SERVE_SPEC_GRAMMAR}"
                )
            if name in tiers:
                raise ValueError(f"tiers names tier {name!r} twice")
            tiers[name] = cls.parse(spec, method)
        return tiers

    @staticmethod
    def format_tiers(tiers: dict[str, "ServeSpec"]) -> str:
        """Inverse of ``parse_tiers``: ``parse_tiers(format_tiers(t)) == t``."""
        return ",".join(f"{name}={spec}" for name, spec in tiers.items())

    # -- materialization ---------------------------------------------------

    def materialize(
        self, cfg: Optional[ModelConfig] = None, params: Any = None,
        *, name: str = "default", verbose: bool = False,
    ):
        """What the serving engine takes: ``None`` (fp), a
        ``PrecisionPlan`` or a ``KernelSchedule``.

        A uniform ``w<bits>a<bits>`` level becomes a one-level plan with
        ``use_kernel=True``, where the reference returns the level's
        ``QuantPolicy``: every site is the same, but the port's
        kernel-ready sites (bits <= 8) then run the ``quant_matmul``
        kernel rather than the float emulation of the integer matmul.
        ``plan`` runs the sensitivity planner against ``(cfg, params)`` —
        both required for that level only — and stamps its plan
        ``use_kernel=True`` for the same reason.  ``:fused`` adds
        ``fuse=True`` as in the reference.  ``schedule=<path>`` loads a
        compiled schedule, refusing one the JAX package compiled."""
        from repro_torch.core.precision.plan import PrecisionPlan

        if self.level == "fp":
            return None
        if self.level == "schedule":
            # a compiled KernelSchedule (launch/compile.py output); the
            # engine also accepts the raw path via its ``schedule=`` kwarg,
            # which additionally applies attention tiles + bucket hashing
            from repro_torch.serving.batching import load_schedule

            return load_schedule(self.path)[0]
        if self.level == "plan":
            if cfg is None or params is None:
                raise ValueError(
                    f"serve spec {self.format()!r} needs a model to plan "
                    f"against (cfg and params)"
                )
            from repro_torch.core.precision import plan_model

            plan, report = plan_model(cfg, params, method=self.method, name=name,
                                      use_kernel=True, fuse=self.fused)
            if verbose:
                print(f"tier {name!r}: planned mixed precision "
                      f"{report['level_counts']} "
                      f"({report['weight_bytes']/1e6:.2f}MB modeled weights)")
            return plan
        return PrecisionPlan(default=self.level, method=self.method, use_kernel=True,
                             fuse=self.fused, name=self.level)
