"""Ahead-of-time kernel-plan compiler CLI (port of
``repro/launch/compile.py``).

Lowers ``(model config, precision spec)`` to a serialized
:class:`~repro_torch.core.precision.compiler.KernelSchedule` that the
serving engine loads at startup (``launch/serve.py --schedule``)::

    # compile the seed schedule (the kernels' launch tiles, no timing runs)
    python -m repro_torch.launch.compile --arch vggt-1b \\
        --spec w4a8:fused --out vggt.schedule.json

    # an LM: a uniform spec lowers on the meta device, no weights drawn
    python -m repro_torch.launch.compile --arch qwen3-14b \\
        --spec w4a8:fused --out qwen3.schedule.json

    # plan mixed precision on the seed-0 weights and time each kernel
    # signature on the card, persisting the times so re-compiles are free
    python -m repro_torch.launch.compile --arch vggt-1b --spec plan:fused \\
        --tune --db tune.json --out vggt.schedule.json

    # drift gate: recompile and diff against a pinned schedule
    python -m repro_torch.launch.compile --arch vggt-1b-smoke \\
        --spec w4a8:fused --check pinned.schedule.json

``--check`` exits non-zero when the freshly compiled schedule differs
from the pinned one — any change to fusion preconditions, launch tiles,
or site naming must re-pin it intentionally.

The compiler runs on the CUDA device (the planner's weights, the tuner's
timings, the schedule's ``backend``) unless ``--device cpu`` is given;
without a CUDA device and without that flag it exits non-zero.  A
schedule the JAX package compiled (backend ``interpret`` or ``tpu``)
carries TPU tilings: recompile it here before serving it.  It lowers
VGGT configs and every LM of the registry (qwen3-14b, rwkv6-1.6b,
deepseek-moe-16b, deepseek-v2-lite-16b, phi3-mini-3.8b, paligemma-3b,
internlm2-20b, starcoder2-7b, musicgen-large, jamba-v0.1-52b and their
smoke configs); an unknown arch exits 2 with the registry's error.  A
uniform spec lowers on
the ``meta`` device and draws no weights, so a full-depth config compiles
on any host; ``plan`` draws the seed-0 weights on ``--device``.
"""
from __future__ import annotations

import argparse
import difflib
import json
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.precision.compiler import KernelSchedule, compile_schedule
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.core.precision.tuner import Autotuner, TuningDB
from repro_torch.launch.specs import SERVE_SPEC_GRAMMAR, ServeSpec


def build_plan(spec: ServeSpec, cfg, *, device="cuda", verbose: bool = False) -> PrecisionPlan:
    """The spec's :class:`PrecisionPlan` (compiler input).

    Unlike ``ServeSpec.materialize`` this maps ``fp`` onto a uniform bf16
    plan (every site lowers to the fp kernel).  ``plan`` runs the
    sensitivity planner on the seed-0 weights drawn on ``device``, and
    stamps the plan ``use_kernel=True`` as ``materialize`` does.
    """
    if spec.level == "schedule":
        raise ValueError("--spec schedule=<path> is already compiled")
    if spec.level == "plan":
        from repro_torch.core.precision import plan_model
        from repro_torch.models import lm, vggt

        dev = torch.device(device)
        params = (vggt if cfg.vggt else lm).init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        plan, report = plan_model(cfg, params, method=spec.method, name="plan",
                                  use_kernel=True, fuse=spec.fused)
        if verbose:
            print(f"planned mixed precision: {report['level_counts']}")
        return plan
    level = "bf16" if spec.level == "fp" else spec.level
    return PrecisionPlan(
        default=level, method=spec.method,
        use_kernel=spec.level != "fp", fuse=spec.fused, name=spec.level,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b-smoke",
                    help="a ported config: vggt-1b, qwen3-14b, rwkv6-1.6b, deepseek-moe-16b, "
                         "phi3-mini-3.8b, paligemma-3b, each also as -smoke")
    ap.add_argument("--spec", default="w4a8:fused",
                    help=f"precision spec: {SERVE_SPEC_GRAMMAR}")
    ap.add_argument("--method", default="versaq", help="versaq|quarot|rtn")
    ap.add_argument("--out", default=None, help="write the schedule JSON here")
    ap.add_argument("--check", default=None, metavar="GOLDEN",
                    help="compile and diff against this pinned schedule; "
                         "exit 1 on drift")
    ap.add_argument("--tune", action="store_true",
                    help="time each kernel signature (default: launch tiles, untimed)")
    ap.add_argument("--budget", type=int, default=8,
                    help="autotuner candidates per site signature")
    ap.add_argument("--db", default=None,
                    help="tuning-DB JSON path (persists winners across runs)")
    ap.add_argument("--device", default="cuda",
                    help="where to plan and tune, and the schedule's backend "
                         "(default: the CUDA device; no fallback)")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(f"--arch {args.arch}: {e.args[0]}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("compile: RuntimeError: the compiler runs on the CUDA device unless told "
              "otherwise, and no CUDA device is available; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    try:
        spec = ServeSpec.parse(args.spec, args.method)
        plan = build_plan(spec, cfg, device=dev, verbose=True)
        tuner = None
        if args.tune:
            tuner = Autotuner(db=TuningDB(args.db), budget=args.budget, device=dev.type)
        sched = compile_schedule(cfg, plan, tuner=tuner, backend=dev.type)
    except ValueError as e:
        print(f"compile: ValueError: {e}", file=sys.stderr)
        return 1
    print(f"compiled {args.arch} x {spec}: {sched.summary()} "
          f"sites={len(sched.sites)} groups={len(sched.groups)} "
          f"hash={sched.hash[:12]}")
    if tuner is not None:
        print(f"autotune: {tuner.timing_runs} timing runs, "
              f"{tuner.db.hits} DB hits / {tuner.db.misses} misses"
              + (f" -> {args.db}" if args.db else ""))

    if args.check:
        golden = KernelSchedule.load(args.check)
        if golden.hash != sched.hash:
            print(f"SCHEDULE DRIFT vs {args.check}:", file=sys.stderr)
            _diff(golden, sched)
            return 1
        print(f"schedule matches golden {args.check}")

    if args.out:
        sched.save(args.out)
        print(f"wrote {args.out}")
    return 0


def _diff(golden: KernelSchedule, fresh: KernelSchedule) -> None:
    """Line-level canonical-JSON diff, printed to stderr."""
    a = json.dumps(golden.canonical(), indent=2, sort_keys=True).splitlines()
    b = json.dumps(fresh.canonical(), indent=2, sort_keys=True).splitlines()
    for line in difflib.unified_diff(a, b, "golden", "compiled", lineterm="", n=2):
        print(line, file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
