"""Seeded, deterministic fault injection for the serving stack (port of
``repro/serving/faults.py``, numpy only).

The paper's deployment regime — W4A4-adjacent precision tiers with
saturated activation channels — makes numeric faults an *expected*
production event, not a corner case.  This module is the chaos half of
the robustness layer (docs/robustness.md): a declarative
:class:`FaultPlan` describes exactly which faults fire where, a
:class:`FaultInjector` replays the plan deterministically against live
engine traffic, and the engines query it only when a plan is armed —
with no plan (the default) every hook is a single ``is None`` check and
the hot path runs exactly as in a fault-free engine.

The port's VGGT engine fires the ``scene`` (nan/inf), ``prefill`` and
``poll`` (latency, crash) sites; its LM engine the ``prefill.logits`` and
``decode.logits`` (nan/inf), ``prefill``, ``decode`` and ``poll`` sites in
both modes, and ``slot_alloc`` at the continuous scheduler's admission.

Fault kinds:

* ``nan`` / ``inf`` — inject a non-finite value into a named activation
  site (``decode.logits``, ``prefill.logits``, ``scene``) for one
  request's rows, exercising the numeric-fault quarantine;
* ``latency`` — sleep before a named stage (``decode``, ``prefill``,
  ``poll``), exercising deadline eviction and the degradation ladder;
* ``slot_alloc`` — fail a request's decode-slot allocation at admission
  (the request fails; co-admitted requests continue);
* ``crash`` — raise :class:`InjectedFault` out of ``engine.poll()``,
  exercising the async server's strike counter and abort escalation.

``--faults`` grammar (``launch/serve.py``; specs separated by ``;``)::

    spec := kind ['@' site] [':' key '=' val (',' key '=' val)*]
    plan := spec (';' spec)* [';' 'seed=' int]

    keys := req=<enqueue ordinal, 0-based>  step=<decode step, 0-based>
            times=<max fires, 0 = unlimited>  seconds=<sleep>
            p=<fire probability, seeded>

Examples::

    nan@decode.logits:req=1,step=3
    inf@prefill.logits:req=0;latency@decode:seconds=0.02,times=4
    crash@poll:times=3,p=0.5;seed=7

Determinism: ``req`` matches the engine's enqueue ordinal (the Nth
``enqueue`` call, 0-based — retries keep their ordinal), ``step`` the
request-relative decode step, and probabilistic specs draw from one
``numpy`` generator seeded by the plan — the same plan against the same
arrival script injects the same faults every run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serving.batching import ServeError

__all__ = [
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
    "ACTIVATION_SITES",
    "LATENCY_SITES",
]

KINDS = ("nan", "inf", "latency", "slot_alloc", "crash")
ACTIVATION_SITES = ("decode.logits", "prefill.logits", "scene")
LATENCY_SITES = ("decode", "prefill", "poll")
_DEFAULT_SITE = {"nan": "decode.logits", "inf": "decode.logits",
                 "latency": "decode", "crash": "poll", "slot_alloc": ""}


class InjectedFault(ServeError):
    """An injected fault fired (chaos testing only) — delivered directly
    through ``PendingRequest.result()`` for request-scoped faults, or
    raised out of ``engine.poll()`` for ``crash`` specs."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault: what fires, where, and for whom."""

    kind: str
    site: str = ""
    req: Optional[int] = None  # enqueue ordinal (None = any request)
    step: Optional[int] = None  # decode step, 0-based (None = any step)
    times: int = 1  # max fires; 0 = unlimited
    seconds: float = 0.0  # latency specs only
    p: float = 1.0  # fire probability (seeded by the plan)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: expected {KINDS}")
        site = self.site or _DEFAULT_SITE[self.kind]
        object.__setattr__(self, "site", site)
        if self.kind in ("nan", "inf") and site not in ACTIVATION_SITES:
            raise ValueError(
                f"{self.kind} site {site!r}: expected one of {ACTIVATION_SITES}"
            )
        if self.kind == "latency" and site not in LATENCY_SITES:
            raise ValueError(
                f"latency site {site!r}: expected one of {LATENCY_SITES}"
            )
        if self.kind == "crash" and site != "poll":
            raise ValueError(f"crash site {site!r}: only 'poll' is supported")
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"p={self.p}: expected 0 < p <= 1")

    @property
    def value(self) -> float:
        return float("nan") if self.kind == "nan" else float("inf")

    def format(self) -> str:
        s = self.kind + (f"@{self.site}" if self.site else "")
        kv = []
        if self.req is not None:
            kv.append(f"req={self.req}")
        if self.step is not None:
            kv.append(f"step={self.step}")
        if self.times != 1:
            kv.append(f"times={self.times}")
        if self.seconds:
            kv.append(f"seconds={self.seconds:g}")
        if self.p < 1.0:
            kv.append(f"p={self.p:g}")
        return s + (":" + ",".join(kv) if kv else "")

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        head, _, tail = text.strip().partition(":")
        kind, _, site = head.partition("@")
        kw: dict = {}
        if tail:
            for pair in tail.split(","):
                k, sep, v = pair.partition("=")
                k = k.strip()
                if not sep or k not in ("req", "step", "times", "seconds", "p"):
                    raise ValueError(
                        f"fault spec {text!r}: bad key/value {pair!r} "
                        "(expected req= step= times= seconds= p=)"
                    )
                kw[k] = float(v) if k in ("seconds", "p") else int(v)
        return cls(kind=kind.strip(), site=site.strip(), **kw)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable set of :class:`FaultSpec` plus the RNG seed for
    probabilistic specs.  Parse with :meth:`parse`; arm an engine with
    ``Engine(..., faults=plan)`` (a plan string is accepted too)."""

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs, seed = [], 0
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            specs.append(FaultSpec.parse(part))
        if not specs:
            raise ValueError(f"fault plan {text!r} declares no faults")
        return cls(specs=tuple(specs), seed=seed)

    def format(self) -> str:
        out = ";".join(s.format() for s in self.specs)
        return out + (f";seed={self.seed}" if self.seed else "")


class FaultInjector:
    """Runtime state for one engine's :class:`FaultPlan`: enqueue
    ordinals, remaining fire counts, and the seeded RNG.  Engines call
    the hook methods below; every hook is a no-op scan over the (tiny)
    spec tuple, and none is reached at all when the engine was built
    without a plan."""

    def __init__(self, plan: FaultPlan | str):
        self.plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
        self._rng = np.random.default_rng(self.plan.seed)
        self._left = [s.times for s in self.plan.specs]
        self._ordinals: dict[str, int] = {}
        self._count = 0
        self.fired: dict[str, int] = {}

    def on_enqueue(self, req) -> None:
        """Record the request's enqueue ordinal (``req=`` matching)."""
        if req.req_id not in self._ordinals:
            self._ordinals[req.req_id] = self._count
            self._count += 1

    # -- matching / bookkeeping ------------------------------------------

    def _req_ok(self, s: FaultSpec, req_id: Optional[str]) -> bool:
        if s.req is None:
            return True
        return req_id is not None and self._ordinals.get(req_id) == s.req

    def _try_fire(self, i: int, s: FaultSpec) -> bool:
        if self._left[i] == 0 and s.times != 0:
            return False
        if s.p < 1.0 and self._rng.random() >= s.p:
            return False
        if self._left[i] > 0:
            self._left[i] -= 1
        self.fired[s.kind] = self.fired.get(s.kind, 0) + 1
        return True

    # -- engine hooks ----------------------------------------------------

    def activation(
        self, site: str, req_id: str, step: Optional[int] = None
    ) -> Optional[float]:
        """NaN/Inf to add to the request's activations at ``site`` (and
        decode ``step``), or None when no spec fires."""
        for i, s in enumerate(self.plan.specs):
            if (
                s.kind in ("nan", "inf")
                and s.site == site
                and self._req_ok(s, req_id)
                and (s.step is None or s.step == step)
                and self._try_fire(i, s)
            ):
                return s.value
        return None

    def sleep(self, site: str) -> float:
        """Sleep for every firing latency spec at ``site``; returns the
        seconds slept (0.0 when nothing fired)."""
        total = 0.0
        for i, s in enumerate(self.plan.specs):
            if s.kind == "latency" and s.site == site and self._try_fire(i, s):
                total += s.seconds
        if total > 0:
            time.sleep(total)
        return total

    def alloc_fails(self, req_id: str) -> bool:
        """True when a ``slot_alloc`` spec fails this request's
        decode-slot allocation."""
        for i, s in enumerate(self.plan.specs):
            if s.kind == "slot_alloc" and self._req_ok(s, req_id) and self._try_fire(i, s):
                return True
        return False

    def crash(self, site: str = "poll") -> None:
        """Raise :class:`InjectedFault` when a ``crash`` spec fires."""
        for i, s in enumerate(self.plan.specs):
            if s.kind == "crash" and s.site == site and self._try_fire(i, s):
                raise InjectedFault(f"injected {site} crash ({s.format()})")
