"""Autotuner + persisted tuning DB backing the kernel-plan compiler (port
of ``repro/core/precision/tuner.py``).

The compiler (:mod:`repro_torch.core.precision.compiler`) lowers each
weight site to a kernel choice plus launch tiles.  Without a tuner it
records each kernel's launch tiles; with one, each distinct
``(kernel, shape, bits, fusion, backend)`` signature is timed once and the
winner persisted, so re-compiling an already-tuned config performs
**zero** timing runs.

Candidates are the launch tiles the port's kernels offer
(``kernels.ops.launch_tiles``): one per kernel today, since each Hopper
kernel launches one fixed tiling and masks ragged edges itself.  The TPU
tile grid of the reference (``lane_tile`` targets) is not ported.  So the
DB holds what the card takes per signature; more candidates come with
kernel variants.

The cost signal follows the tuner's ``device``:

* ``cuda`` — the real kernel at ``TUNE_M`` tokens (attention: ``TUNE_LQ``
  queries over ``TUNE_LK`` keys; a routed-expert site's batched launch:
  ``TUNE_EXPERT_M`` rows for each expert), timed with ``kernels.measure.time_ms``
  (median of CUDA-event runs, L2 flushed), in milliseconds;
* ``cpu`` — the modeled bytes the kernel's function moves at that size,
  as its wrapper records them in ``kernels.probe`` when it launches.

Either way every candidate evaluation counts as a timing run.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Optional

import torch

from repro_torch.core.quantize import quantize_weight
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import two_stage_attention as _tsa

__all__ = ["TuningDB", "Autotuner", "matmul_key", "batched_key", "attention_key", "ffn_key"]

DB_VERSION = 1

# Reference token count used when timing matmul candidates — the real M is
# runtime-dependent, so candidates are ranked at a representative size.
TUNE_M = 256
# Rows per expert when timing a MoE layer's batched launch: each expert's
# capacity in a 2 x 512-token prefill wave of deepseek-moe-16b (64 experts,
# top-6, capacity factor 1.25).
TUNE_EXPERT_M = 120
# Reference sequence lengths for attention candidates.
TUNE_LQ = 256
TUNE_LK = 1024
BACKENDS = ("cuda", "cpu")


def matmul_key(
    k: int,
    n: int,
    *,
    w_bits: int,
    a_bits: int,
    packed: bool,
    fused: bool,
    backend: str,
    norm: Optional[str] = None,
) -> str:
    """DB key for a matmul site: shape x dtype x fusion x backend.
    ``fused`` sites run ``fused_matmul``; ``norm`` names its absorbed
    pre-norm (a fused QKV group's prologue)."""
    return (
        f"quant_matmul|k{k}xn{n}|w{w_bits}a{a_bits}"
        f"|packed{int(packed)}|fused{int(fused)}"
        + (f"|norm{norm}" if norm is not None else "")
        + f"|{backend}"
    )


def batched_key(k: int, n: int, *, experts: int, w_bits: int, a_bits: int, packed: bool,
                backend: str) -> str:
    """DB key for a MoE layer's routed-expert site: ``quant_matmul``'s
    batched launch over ``experts`` stacked weights (its tiles are the 2-D
    launch's, but its time is not)."""
    return (f"quant_matmul_batched|e{experts}xk{k}xn{n}|w{w_bits}a{a_bits}"
            f"|packed{int(packed)}|{backend}")


def attention_key(head_dim: int, *, backend: str) -> str:
    return f"two_stage_mha|dh{head_dim}|{backend}"


def ffn_key(
    d: int, dff: int, d_out: int, *, w_bits_up: int, w_bits_down: int, a_bits_in: int,
    a_bits_mid: int, gated: bool, norm: Optional[str], backend: str,
) -> str:
    """DB key for a fused FFN group (one ``fused_ffn`` launch): widths,
    the gate/up and down weight bits (4 = packed), the input and hidden
    activation bits, gating, the absorbed pre-norm, backend."""
    return (
        f"fused_ffn|d{d}xff{dff}xn{d_out}|w{w_bits_up}w{w_bits_down}"
        f"a{a_bits_in}a{a_bits_mid}|gated{int(gated)}|norm{norm}|{backend}"
    )


class TuningDB:
    """JSON-file-backed map from tuning key to winning tiles.

    Counts ``hits`` / ``misses`` so tests can assert that a second compile
    of an already-tuned config never re-times anything.
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self.entries: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self._dirty = False
        if path is not None and os.path.exists(path):
            with open(path) as f:
                blob = json.load(f)
            if blob.get("version") != DB_VERSION:
                raise ValueError(f"tuning DB version {blob.get('version')!r} != {DB_VERSION}")
            self.entries = dict(blob.get("entries", {}))

    def get(self, key: str) -> Optional[dict]:
        entry = self.entries.get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry
        self._dirty = True

    def save(self) -> None:
        if self.path is None or not self._dirty:
            return
        blob = {"version": DB_VERSION, "entries": dict(sorted(self.entries.items()))}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)
        self._dirty = False


@dataclasses.dataclass
class Autotuner:
    """Times candidate tilings and persists winners in a :class:`TuningDB`.

    ``budget`` caps candidates evaluated per site signature.  ``device``
    (``cuda`` or ``cpu``) picks the cost signal and is the ``backend`` of
    every key.  ``measure`` is injectable for tests: ``measure(kind,
    tiles) -> cost`` replaces both the wall-clock and the modeled-bytes
    paths; ``kind`` is the kernel (``quant_matmul``,
    ``quant_matmul_batched``, ``fused_matmul``, ``fused_ffn``) or
    ``two_stage_mha``.
    """

    db: TuningDB
    budget: int = 8
    device: str = "cuda"
    measure: Optional[Callable[[str, dict], float]] = None
    timing_runs: int = 0

    def __post_init__(self) -> None:
        self.backend = torch.device(self.device).type
        if self.backend not in BACKENDS:
            raise ValueError(f"Autotuner device {self.device!r}: expected one of {BACKENDS}")

    # -- matmul sites ---------------------------------------------------

    def tune_matmul(
        self, k: int, n: int, *, w_bits: int, a_bits: int, packed: bool, fused: bool,
        norm: Optional[str] = None,
    ) -> dict:
        kernel = "fused_matmul" if fused else "quant_matmul"
        key = matmul_key(k, n, w_bits=w_bits, a_bits=a_bits, packed=packed, fused=fused,
                         backend=self.backend, norm=norm)
        return self._tune(key, kernel, lambda t: self._matmul_cost(
            t, kernel, k, n, w_bits=w_bits, a_bits=a_bits, packed=packed, norm=norm))

    def _matmul_cost(self, tiles: dict, kernel: str, k: int, n: int, *, w_bits: int,
                     a_bits: int, packed: bool, norm: Optional[str]) -> float:
        self.timing_runs += 1
        if self.measure is not None:
            return float(self.measure(kernel, tiles))
        if self.backend == "cpu":
            if kernel == "quant_matmul":
                return float(_qm.function_bytes(TUNE_M, k, n, packed=packed))
            return float(_fused.matmul_function_bytes(TUNE_M, k, n, packed=packed,
                                                      norm_u=norm == "ln", bias=True, idct=True))
        dev = torch.device(self.device)
        x = _ramp((TUNE_M, k), dev)
        if kernel == "quant_matmul":
            wq = quantize_weight(_ramp((k, n), dev), w_bits)
            return _time(lambda: kernel_ops.quant_linear_matmul(x, wq, a_bits, tiles=tiles))
        site = _fused_site(k, n, w_bits=w_bits, a_bits=a_bits, norm=norm, device=dev)
        return _time(lambda: kernel_ops.fused_linear(x, site, tiles=tiles))

    def tune_matmul_batched(self, k: int, n: int, *, experts: int, w_bits: int, a_bits: int,
                            packed: bool) -> dict:
        """A routed-expert site: the batched launch at ``TUNE_EXPERT_M``
        rows for each of ``experts`` problems.  Its candidates are
        ``quant_matmul``'s launch tiles, which the batched launch shares."""
        key = batched_key(k, n, experts=experts, w_bits=w_bits, a_bits=a_bits, packed=packed,
                          backend=self.backend)

        def cost(tiles):
            self.timing_runs += 1
            if self.measure is not None:
                return float(self.measure("quant_matmul_batched", tiles))
            if self.backend == "cpu":
                return float(_qm.batched_function_bytes(experts, experts, TUNE_EXPERT_M, k, n,
                                                        packed=packed))
            dev = torch.device(self.device)
            x = _ramp((experts, TUNE_EXPERT_M, k), dev)
            one = quantize_weight(_ramp((k, n), dev), w_bits)
            wq = dataclasses.replace(one, values=one.values.expand(experts, -1, -1).contiguous(),
                                     scale=one.scale.reshape(1, 1, n).expand(experts, 1, n)
                                     .contiguous())
            return _time(lambda: kernel_ops.quant_linear_matmul(x, wq, a_bits, tiles=tiles))

        return self._tune(key, "quant_matmul", cost)

    # -- fused FFN groups -----------------------------------------------

    def tune_ffn(
        self, d: int, dff: int, d_out: int, *, w_bits_up: int, w_bits_down: int,
        a_bits_in: int, a_bits_mid: int, gated: bool = False, norm: Optional[str] = None,
    ) -> dict:
        key = ffn_key(d, dff, d_out, w_bits_up=w_bits_up, w_bits_down=w_bits_down,
                      a_bits_in=a_bits_in, a_bits_mid=a_bits_mid, gated=gated, norm=norm,
                      backend=self.backend)

        def cost(tiles):
            self.timing_runs += 1
            if self.measure is not None:
                return float(self.measure("fused_ffn", tiles))
            if self.backend == "cpu":
                packed_u, packed_d = w_bits_up == 4, w_bits_down == 4
                return float(_fused.ffn_function_bytes(
                    TUNE_M, d, dff, d_out, packed_u=packed_u, packed_d=packed_d,
                    packed_g=packed_u, gated=gated, norm_u=norm == "ln", bias_g=gated,
                    bias_u=True, bias_d=True, idct=True))
            dev = torch.device(self.device)
            f = _fused_ffn(d, dff, d_out, w_bits_up=w_bits_up, w_bits_down=w_bits_down,
                           a_bits_in=a_bits_in, a_bits_mid=a_bits_mid, gated=gated, norm=norm,
                           device=dev)
            x = _ramp((TUNE_M, d), dev)
            return _time(lambda: kernel_ops.fused_ffn_apply(x, f, tiles=tiles))

        return self._tune(key, "fused_ffn", cost)

    # -- attention ------------------------------------------------------

    def tune_attention(self, head_dim: int) -> dict:
        key = attention_key(head_dim, backend=self.backend)

        def cost(tiles):
            self.timing_runs += 1
            if self.measure is not None:
                return float(self.measure("two_stage_mha", tiles))
            if self.backend == "cpu":
                return float(_tsa.function_bytes(4, 4, TUNE_LQ, TUNE_LK, head_dim))
            dev = torch.device(self.device)
            q = _ramp((1, 4, TUNE_LQ, head_dim), dev)
            kv = _ramp((1, 4, TUNE_LK, head_dim), dev)
            return _time(lambda: kernel_ops.two_stage_mha(q, kv, kv, tiles=tiles))

        return self._tune(key, "two_stage_attention", cost)

    # -- shared ---------------------------------------------------------

    def _tune(self, key: str, kernel: str, cost_fn) -> dict:
        """A DB hit (whose tiles must be ones ``kernel`` can launch), or
        rank the kernel's candidates and persist the winner."""
        entry = self.db.get(key)
        if entry is not None:
            kernel_ops.launch_tiles(kernel, entry["tiles"])  # raises for foreign tiles
            return dict(entry["tiles"])
        candidates = [kernel_ops.launch_tiles(kernel)]
        best, cost = self._rank(candidates, cost_fn)
        self.db.put(key, {"tiles": best, "cost": cost, "candidates": len(candidates)})
        return dict(best)

    def _rank(self, candidates: list[dict], cost_fn) -> tuple[dict, float]:
        pool = candidates[: max(1, self.budget)]
        best, best_cost = pool[0], cost_fn(pool[0])
        for cand in pool[1:]:
            c = cost_fn(cand)
            if c < best_cost:
                best, best_cost = cand, c
        return best, best_cost

    def flush(self) -> None:
        self.db.save()


def _ramp(shape: tuple, device) -> torch.Tensor:
    """Deterministic values in [-6/7, 6/7] (the reference's timing input)."""
    n = math.prod(shape)
    return ((torch.arange(n, dtype=torch.float32, device=device) % 13.0 - 6.0) / 7.0).reshape(shape)


def _time(fn) -> float:
    from repro_torch.kernels.measure import time_ms

    return float(time_ms(fn))


def _fused_site(k: int, n: int, *, w_bits: int, a_bits: int, norm: Optional[str], device):
    """A fused linear site at a signature: the IDCT and bias epilogue of
    every fused projection, and the absorbed LayerNorm prologue of a QKV
    group when ``norm`` says so."""
    from repro_torch.core.versaq import Epilogue, Prologue, QuantLinear, make_folded_norm

    return QuantLinear(
        qw=quantize_weight(_ramp((k, n), device), w_bits),
        bias=_ramp((n,), device),
        a_bits=a_bits,
        idct=True,
        use_kernel=True,
        prologue=Prologue(norm=norm) if norm is not None else None,
        epilogue=Epilogue(),
        norm_u=make_folded_norm("ln", k, device=device).u if norm == "ln" else None,
    )


def _fused_ffn(d: int, dff: int, d_out: int, *, w_bits_up: int, w_bits_down: int,
               a_bits_in: int, a_bits_mid: int, gated: bool, norm: Optional[str], device):
    """A fused FFN layer at a signature (IDCT on the hidden and the output,
    the hidden's online WHT, biases)."""
    from repro_torch.core.versaq import FusedFFN, QuantLinear, make_folded_norm

    def site(k, n, w_bits, a_bits, rotate):
        return QuantLinear(qw=quantize_weight(_ramp((k, n), device), w_bits),
                           bias=_ramp((n,), device), a_bits=a_bits, rotate_input=rotate,
                           idct=True, use_kernel=True)

    return FusedFFN(
        w_up=site(d, dff, w_bits_up, a_bits_in, False),
        w_down=site(dff, d_out, w_bits_down, a_bits_mid, True),
        w_gate=site(d, dff, w_bits_up, a_bits_in, False) if gated else None,
        norm_u=make_folded_norm("ln", d, device=device).u if norm == "ln" else None,
        act="silu" if gated else "gelu",
        norm=norm,
    )
