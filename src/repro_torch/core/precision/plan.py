"""Per-site precision policy model (port of ``repro/core/precision/plan.py``).

A **site** is a named weight matrix in the model tree, using dotted paths
that mirror the parameter structure:

* VGGT (``models/vggt.py``): ``frame.attn.wq``, ``global.ffn.w_down`` …
  (the LM paths of the reference, ``blocks.l1.ffn.w_down`` …, resolve the
  same way once the LM model is ported).

Stacked layer groups share one leaf per position (``frame`` covers every
group's frame block), as in the reference, whose ``lax.scan`` stacking
forbids per-group leaf dtypes; the plan's granularity matches.  Heads, norms, routers, and the other bf16 islands are not
sites — they are never quantized regardless of the plan.

A **level** is one of ``bf16 | w8a8 | w4a8 | w4a4`` (any ``w<bits>a<bits>``
string parses).  A :class:`PrecisionPlan` maps sites to levels through an
ordered list of glob-style overrides (``fnmatch``; the LAST matching
override wins, so plans read top-down from general to specific), with
JSON round-tripping for deployment artifacts.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re
from typing import Iterable, Optional

from repro_torch.core.versaq import QuantPolicy

__all__ = ["LEVELS", "LayerPolicy", "PrecisionPlan", "level_policy", "parse_level"]

# The accelerator's three datapath modes (paper §IV-B).  ``bf16`` means the
# site is not quantized at all: its weight stays a (transform-fused) float
# matrix and the matmul runs in floating point.
LEVELS = ("bf16", "w8a8", "w4a8", "w4a4")

_LEVEL_RE = re.compile(r"w(\d+)a(\d+)")


def parse_level(level: str) -> Optional[tuple[int, int]]:
    """``"bf16"`` -> None; ``"w4a8"`` -> (4, 8).  Raises on anything else."""
    s = level.strip().lower()
    if s == "bf16":
        return None
    m = _LEVEL_RE.fullmatch(s)
    if m is None:
        raise ValueError(f"unknown precision level {level!r}: expected bf16 or w<bits>a<bits>")
    return int(m.group(1)), int(m.group(2))


def level_policy(level: str, method: str = "versaq") -> Optional[QuantPolicy]:
    """The :class:`QuantPolicy` a level maps to (None for bf16 passthrough)."""
    bits = parse_level(level)
    if bits is None:
        return None
    return QuantPolicy(w_bits=bits[0], a_bits=bits[1], method=method)


@dataclasses.dataclass(frozen=True)
class LayerPolicy:
    """One resolved site assignment — the planner's and ``describe()``'s
    record type: which site, which level, and why (free-form note)."""

    site: str
    level: str
    note: str = ""

    def policy(self, method: str = "versaq") -> Optional[QuantPolicy]:
        return level_policy(self.level, method)


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Sites -> levels via ordered glob overrides (last match wins).

    ``method`` selects the transform flow (versaq | quarot | rtn) and is
    uniform across the plan: the residual stream is either rotated or not,
    and every site must agree on which domain it consumes.

    ``use_kernel`` routes quantized sites through the CUDA
    ``kernels/quant_matmul`` integer kernel instead of the float emulation
    (the kernel is the hot path).

    ``fuse`` turns on the unified-datapath kernel fusion
    (``kernels/fused``): dense FFN triples collapse to one launch per
    layer, Q/K/V merge into one prologue-carrying site that absorbs the
    pre-norm, and output projections run their IDCT/bias epilogue
    in-kernel.  Fusion implies kernel routing at the fused sites.
    """

    default: str = "w4a8"
    overrides: tuple[tuple[str, str], ...] = ()
    method: str = "versaq"
    use_kernel: bool = False
    fuse: bool = False
    name: str = "mixed"

    def __post_init__(self):
        parse_level(self.default)  # validate eagerly, not at resolve time
        for pat, level in self.overrides:
            parse_level(level)
            if not isinstance(pat, str):
                raise TypeError(f"override pattern must be a glob string, got {pat!r}")

    # ---- resolution ------------------------------------------------------

    def resolve(self, site: str) -> str:
        level = self.default
        for pat, lv in self.overrides:
            if fnmatch.fnmatchcase(site, pat):
                level = lv
        return level

    def policy_for(self, site: str) -> Optional[QuantPolicy]:
        """The uniform-policy equivalent for one site (None = bf16)."""
        return level_policy(self.resolve(site), self.method)

    def describe(self, sites: Iterable[str]) -> list[LayerPolicy]:
        """Resolve every site — the printable per-site bit map."""
        return [LayerPolicy(site=s, level=self.resolve(s)) for s in sites]

    # ---- serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "method": self.method,
                "default": self.default,
                "use_kernel": self.use_kernel,
                "fuse": self.fuse,
                "overrides": [list(o) for o in self.overrides],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "PrecisionPlan":
        d = json.loads(text)
        return cls(
            default=d["default"],
            overrides=tuple((p, lv) for p, lv in d.get("overrides", ())),
            method=d.get("method", "versaq"),
            use_kernel=bool(d.get("use_kernel", False)),
            fuse=bool(d.get("fuse", False)),
            name=d.get("name", "mixed"),
        )
