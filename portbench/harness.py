"""One run of one cell: set-up, the measured window, the check of what
the window produced against the plain reference, and the result line.

Everything that belongs to one cell is found by name: ``BENCHMARK.json``
names the cell's configuration and traffic; the configuration file is
``configs/<config>.json`` (its ``driver`` names the module under
``drivers/`` that serves that model family), the traffic mix
``traffic/<traffic>.json``, the limits of the check ``checks/<cell>.json``,
and each metric's reader ``metrics/<name up to the first dot>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# what a run records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Req:
    """One request of the window; times in seconds from the window start."""

    index: int
    client: int = 0
    due: Optional[float] = None  # open loop: its slot on the schedule
    sent: Optional[float] = None
    done: Optional[float] = None
    ok: bool = False
    error: Optional[str] = None
    prompt_len: int = 0
    new_tokens: int = 0
    req_id: Optional[str] = None

    @property
    def start(self) -> Optional[float]:
        """When the request was owed service: due (open) or sent (closed)."""
        return self.due if self.due is not None else self.sent


@dataclasses.dataclass
class Batch:
    """One engine call (a VGGT micro-batch or an LM prefill wave)."""

    t0: float
    t1: float
    real: int  # real items (scenes or prompt rows)
    batch: int  # padded batch bucket
    length: int = 0  # LM: prompt bucket
    lens: tuple = ()  # LM: each real row's prompt length


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seed: int
    window_s: float
    trace: bool
    setup_s: float = 0.0
    requests: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)  # obs trace events (traced)
    stats: dict = dataclasses.field(default_factory=dict)  # engine counters over the window
    profile: dict = dataclasses.field(default_factory=dict)  # SubWindow.reduce()
    checks: dict = dataclasses.field(default_factory=dict)  # name -> compared number
    slots: dict = dataclasses.field(default_factory=dict)  # req_id -> row of its engine call
    memory_peak_bytes: int = 0
    notes: list = dataclasses.field(default_factory=list)

    def in_window(self) -> list:
        """Requests owed service inside the window."""
        return [r for r in self.requests if r.start is not None and r.start < self.window_s]


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(man: dict, cell: str, root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic mix, check limits) of a cell."""
    wl = next((w for w in man["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise KeyError(f"no workload {cell!r}; have {[w['name'] for w in man['workloads']]}")
    entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    config = load_json(os.path.join(root, entry["file"]))
    here = os.path.join(root, "portbench")
    traffic = load_json(os.path.join(here, "traffic", f"{wl['traffic']}.json"))
    checks = load_json(os.path.join(here, "checks", f"{cell}.json"))
    return wl, config, traffic, checks


def cell_metrics(man: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: end-to-end untraced,
    per-layer traced; a metric without ``workloads`` is every cell's."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}").read


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def require_chips(n: int) -> str:
    """The card's name; exits with code 3 when fewer than ``n`` CUDA
    devices are present (no CPU fallback)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: this cell needs {n} CUDA device(s); found {have}", file=sys.stderr)
        sys.exit(3)
    return torch.cuda.get_device_name(0)


def power_line(fields: str = "name,power.limit") -> str:
    """The first card's ``fields`` as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


# what sets a card's speed for a whole run: a run that reads slow throughout,
# with no stall on the host, shows here
CLOCK_FIELDS = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw,clocks_throttle_reasons.active"


def run_cell(cell: str, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             *, t_process: float, device: str = "cuda", control: bool = False) -> Run:
    """Set up, serve the window and check it; ``control`` serves the
    configuration's lower-precision control tier in place of its tier."""
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed, window_s=float(seconds),
              trace=trace)
    if device == "cuda":
        build_kernels(run)
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    driver.run(run, t_process=t_process, device=device,
               tier=config["control_tier"] if control else config["tier"])
    return run


def build_kernels(run: Run) -> None:
    """Build the port's kernels with nvcc (a checkout's first run) or find
    them built, before anything launches one.  The time stays in
    ``setup_s``, which includes compilation; the note marks the run that
    compiled."""
    from repro_torch.kernels import _build

    t = time.perf_counter()
    report = _build.build_all()
    built = sorted(name for name, r in report.items() if r["seconds"] > 0)
    what = f"built {', '.join(built)} with nvcc" if built else "found all built"
    run.notes.append(f"kernels: {what} in {time.perf_counter() - t:.2f} s (inside setup_s)")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(run: Run, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit."""
    shown = {}
    ok = bool(run.checks)
    for name, limit in limits.items():
        value = run.checks.get(name)
        shown[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    attempted = run.in_window()
    if not attempted or any(not r.ok for r in attempted):
        ok = False
    return ok, shown


def result_line(run: Run, man: dict, limits: dict, device_kind: str, n_chips: int) -> dict:
    metrics = {}
    seen = len(run.notes)
    for m in cell_metrics(man, run.cell, run.trace):
        value = reader(m["name"])(run)
        if value is None:
            print(f"portbench: metric {m['name']} found nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for note in run.notes[seen:]:
        print(f"portbench: {note}", file=sys.stderr)
    correct, shown = judge(run, limits)
    attempted = run.in_window()
    device = {"platform": "gpu", "kind": device_kind, "count": n_chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": correct, "attempted": len(attempted),
           "failed": sum(1 for r in attempted if not r.ok), "metrics": metrics, "device": device}
    if run.trace:
        from portbench import breakdown

        busy, window = breakdown.busy_window(run)
        device["busy_s"], device["window_s"] = busy, window
        out["breakdown"] = breakdown.breakdown(run)
    out["checks"] = shown
    return out


def main(argv: list[str], t_process: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the CUDA device.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="serve the configuration's lower-precision control tier instead "
                         "(its check should come out not correct)")
    args = ap.parse_args(argv)
    man = manifest()
    wl, config, traffic, limits = cell_files(man, args.workload)
    kind = require_chips(wl["chips"])
    print(f"device: {kind}; {power_line()}", flush=True)
    run = run_cell(args.workload, config, traffic, args.seed, args.seconds, bool(args.trace),
                   t_process=t_process, control=args.control)
    owed = run.in_window()
    print(f"samples: {len(owed)} requests owed in the window, {sum(r.ok for r in owed)} "
          f"delivered; a p95 has {len(owed) - math.ceil(0.95 * len(owed))} beyond it", flush=True)
    for note in run.notes:
        print(note, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; the port must not use JAX", file=sys.stderr)
        return 4
    out = result_line(run, man, limits, kind, wl["chips"])
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
