"""Serving launcher: quantize + serve batched requests through a bucketed
engine behind the async server loop (port of ``repro/launch/serve.py``):
VGGT scenes through ``VGGTEngine``, LM prompts through the LM ``Engine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --tiers quality=fp,balanced=w4a8 --requests 4 --prompt-len 512 \\
      --gen 32 --batch 2

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --tiers fp=fp,w4a8=w4a8 --requests 6 --prompt-len 256 --gen 32 --batch 4

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b-smoke \\
      --tiers quality=fp,balanced=w4a8 --requests 4 --prompt-len 8 --gen 8 --batch 2

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b-smoke \\
      --tiers quality=fp,balanced=w4a8 --requests 4 --prompt-len 8 --gen 8 --batch 2

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vggt-1b \\
      --tiers quality=fp,balanced=w4a8,planned=plan:fused,fast=w4a8:fused \\
      --attn-impl two_stage --requests 8 --scenes 1 --frames 8 --patches 1024 \\
      --batch 2 --metrics-port 0

  # serve a schedule compiled by ``python -m repro_torch.launch.compile``
  PYTHONPATH=src python -m repro_torch.launch.serve --arch vggt-1b \\
      --schedule build/vggt.schedule.json --attn-impl two_stage ...
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --schedule build/qwen3.schedule.json --requests 4 --prompt-len 512 ...

Precision tiers (one engine, several quantization levels; requests are
assigned tiers round-robin and only coalesce within their tier).  Tier
specs: ``fp`` (full precision), ``w<bits>a<bits>`` (uniform, on the
``quant_matmul`` kernel), ``plan`` (the sensitivity planner's mixed plan
on the seed-0 weights), ``schedule=<path>`` (a compiled kernel schedule),
and ``:fused`` variants (``w4a8:fused``, ``plan:fused``) that serve
through the unified-datapath kernels (``fused_matmul`` for Q/K/V and
``wo``, one ``fused_ffn`` launch per FFN) wherever the plan lets a group
fuse.  ``--schedule`` serves one compiled schedule (its launch tiles, its
hash in the bucket keys) and conflicts with ``--tiers``.

The LM branch serves ``mixed_len_prompts`` traffic (full and 3/4-length
prompts, so the masked length-padded buckets serve too; rwkv serves each
at its exact length) with ``max_len = --prompt-len + --gen``.  ``--mode``
picks the scheduler: ``continuous`` (slot-batched: requests join the
running decode batch), ``bucket`` (drain-then-refill) or ``auto`` (the
default: continuous wherever the config supports it, which every ported
LM does), with ``--tiers`` (``plan[:fused]`` plans on the seed-0 weights)
or one ``--schedule``.

The launcher runs on the CUDA device; ``--device cpu`` runs it on the
CPU (each kernel wrapper then takes its plain PyTorch version).  Without
a CUDA device and without ``--device cpu`` it exits non-zero.
"""
import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import mixed_len_prompts, scene_batch
from repro_torch.serving.batching import resolve_device
from repro_torch.serving.server import AsyncServer


def _parse_policy(s: str, method: str):
    """Thin wrapper over :class:`repro_torch.launch.specs.ServeSpec` — one
    shared grammar for ``--policy`` and ``--tiers`` values."""
    from repro_torch.launch.specs import ServeSpec

    try:
        spec = ServeSpec.parse(s, method)
    except ValueError as e:
        raise ValueError(f"policy {s!r}: {e}") from e
    if spec.level == "plan":
        raise ValueError(
            f"policy {s!r}: 'plan' is only valid in --tiers "
            f"(the planner needs named tiers + weights)"
        )
    return spec.materialize()


def _policy(args):
    return _parse_policy(args.policy, args.method)


def _tiers(args, cfg, params) -> dict | None:
    """Parse ``--tiers name=spec,...`` via ``ServeSpec.parse_tiers``."""
    from repro_torch.launch.specs import ServeSpec

    specs = ServeSpec.parse_tiers(args.tiers, args.method)
    if specs is None:
        return None
    return {
        name: spec.materialize(cfg, params, name=name, verbose=True)
        for name, spec in specs.items()
    }


def _tier_cycle(tiers: dict | None, n: int) -> list[str | None]:
    """Round-robin tier assignment for n requests (None = default path)."""
    if not tiers:
        return [None] * n
    names = list(tiers)
    return [names[i % len(names)] for i in range(n)]


def _robustness_kwargs(args) -> dict:
    """Fault-tolerance flags (docs/robustness.md) for the engine
    constructor: admission bounds, degradation ladder, chaos plan."""
    kw: dict = {}
    if args.max_pending is not None:
        kw["max_pending"] = args.max_pending
    if args.max_queued_tokens is not None:
        kw["max_queued_tokens"] = args.max_queued_tokens
    if args.max_pending is not None or args.max_queued_tokens is not None:
        kw["admission"] = args.admission
    if args.degrade:
        kw["degrade"] = True
    if args.faults is not None:
        kw["faults"] = args.faults
    return kw


def _collect(srv: AsyncServer, reqs: list) -> list:
    """Gather results, reporting per-request serving errors (quarantine,
    shed, deadline — expected events under --faults / admission bounds)
    instead of dying on the first one.  Returns the successful outputs."""
    from repro_torch.serving.batching import ServeError

    outs = []
    for i, r in enumerate(reqs):
        if r is None:  # rejected at submit (QueueFull under --admission reject)
            continue
        try:
            outs.append(srv.result(r, timeout=600))
        except ServeError as e:
            print(f"request {i}: {type(e).__name__}: {e}")
    return outs


def _submit(srv: AsyncServer, i: int, *a, **kw):
    """Submit one request; a QueueFull at enqueue (admission reject) is an
    expected outcome under --max-pending, not a launcher crash."""
    from repro_torch.serving.batching import QueueFull

    try:
        return srv.submit(*a, **kw)
    except QueueFull as e:
        print(f"request {i}: QueueFull: {e}")
        return None


def _server(eng, args) -> AsyncServer:
    """AsyncServer wired to the CLI's telemetry flags: ``--metrics-port``
    exposes /metrics, /stats, /trace and /healthz (docs/observability.md)
    and turns live telemetry on; ``--trace-jsonl`` mirrors span events to
    a file."""
    if args.trace_jsonl is not None:
        from repro_torch import obs

        obs.enable_all(trace_path=args.trace_jsonl)
    srv = AsyncServer(eng, metrics_port=args.metrics_port)
    srv.start()
    if srv.metrics_address is not None:
        host, port = srv.metrics_address
        print(f"telemetry: http://{host}:{port}/metrics  /stats  /trace  /healthz")
    return srv


def serve_vggt(cfg, args) -> None:
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    dev = resolve_device(args.device, "VGGTEngine")  # the engine's check, before any weights
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = _tiers(args, cfg, params)
    eng = VGGTEngine(
        cfg,
        params,
        policy=None if (tiers or args.schedule) else _policy(args),
        schedule=args.schedule,
        tiers=tiers,
        attn_impl=args.attn_impl,
        max_batch=args.batch,
        max_wait_s=args.max_wait_s,
        device=dev,
        **_robustness_kwargs(args),
    )
    assign = _tier_cycle(tiers, args.requests)
    with _server(eng, args) as srv:
        reqs = [
            _submit(srv, r, torch.as_tensor(
                scene_batch(args.scenes, args.frames, args.patches, cfg.d_model, r)["patches"],
                device=dev,
            ), tier=assign[r])
            for r in range(args.requests)
        ]
        outs = _collect(srv, reqs)
    if not outs:
        print(f"served 0/{len(reqs)} requests")
        print(eng.stats.format())
        return
    out = outs[-1]
    print(f"served {len(outs)}/{len(reqs)} requests -> poses{tuple(out['pose'].shape)} "
          f"points{tuple(out['points'].shape)}")
    print(eng.stats.format())


def serve_lm(cfg, args) -> None:
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    dev = resolve_device(args.device, "Engine")  # the engine's check, before any weights
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = _tiers(args, cfg, params)
    eng = Engine(
        cfg,
        params,
        policy=None if (tiers or args.schedule) else _policy(args),
        schedule=args.schedule,
        tiers=tiers,
        attn_impl=args.attn_impl,
        max_len=args.prompt_len + args.gen,
        max_batch=args.batch,
        max_wait_s=args.max_wait_s,
        mode=args.mode,
        device=dev,
        **_robustness_kwargs(args),
    )
    # mixed-length traffic (full + non-pow2 short prompts) exercises the
    # masked length-padded bucket variants alongside warm bucket reuse
    prompts = mixed_len_prompts(cfg.vocab_size, args.requests, args.prompt_len)
    assign = _tier_cycle(tiers, len(prompts))
    with _server(eng, args) as srv:
        reqs = [
            _submit(srv, i, p, args.gen, tier=t, deadline_s=args.deadline_s)
            for i, (p, t) in enumerate(zip(prompts, assign))
        ]
        outs = _collect(srv, reqs)
    print(f"served {len(outs)}/{len(reqs)} requests -> "
          f"{sum(o.shape[-1] for o in outs)} tokens")
    print(f"prefill {eng.stats.prefill_s * 1e3:.1f}ms  "
          f"decode {eng.stats.decode_s * 1e3:.1f}ms  "
          f"({eng.stats.decode_tokens_per_s:.0f} decode tok/s)")
    print(eng.stats.format())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vggt-1b-smoke",
                    help="a ported config: vggt-1b, vggt-1b-smoke, qwen3-14b, qwen3-14b-smoke, "
                         "rwkv6-1.6b, rwkv6-1.6b-smoke, deepseek-moe-16b, "
                         "deepseek-moe-16b-smoke, phi3-mini-3.8b, phi3-mini-3.8b-smoke "
                         "(paligemma-3b takes embedding inputs, which the LM engine does not serve)")
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default: the CUDA device; no fallback)")
    ap.add_argument("--policy", default="w4a8",
                    help="w<bits>a<bits>[:fused] (w4a8, w4a16, w4a8:fused) | fp")
    ap.add_argument("--tiers", default=None,
                    help="serve precision tiers: name=spec[,name=spec...], "
                         "spec in {fp, w<bits>a<bits>[:fused], plan[:fused], "
                         "schedule=<path>}; overrides --policy")
    ap.add_argument("--schedule", default=None,
                    help="serve from a compiled KernelSchedule JSON "
                         "(repro_torch.launch.compile output, VGGT or LM); overrides "
                         "--policy and conflicts with --tiers")
    ap.add_argument("--method", default="versaq", help="versaq|quarot|rtn")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-wait-s", type=float, default=0.005,
                    help="micro-batch deadline driven by the async loop")
    # lm serving
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mode", default="auto",
                    help="LM scheduler: auto | continuous (slot-based continuous batching) | "
                         "bucket (drain-then-refill)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request SLA: evict (fail) requests not served within this "
                         "many seconds")
    # vggt serving
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=2, help="scenes per request")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--patches", type=int, default=64)
    ap.add_argument("--attn-impl", default=None,
                    help="override cfg.attn_impl (two_stage = INT8 CUDA kernel)")
    # robustness (docs/robustness.md)
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission control: bound the pending queue at "
                         "this many requests (QueueFull past it)")
    ap.add_argument("--max-queued-tokens", type=int, default=None,
                    help="admission control: bound the queued work in "
                         "tokens (prompt+gen for LM, patch tokens for VGGT)")
    ap.add_argument("--admission", default="reject", choices=("reject", "shed"),
                    help="over-full queue policy: reject the new request "
                         "or shed the least-valuable queued one")
    ap.add_argument("--degrade", action="store_true",
                    help="degradation ladder: under sustained SLA pressure "
                         "auto-downshift unpinned admissions to cheaper "
                         "tiers, recover with hysteresis")
    ap.add_argument("--faults", default=None,
                    help="chaos fault plan, e.g. 'nan@scene:req=1;seed=7' or "
                         "'nan@decode.logits:req=1,step=3' "
                         "(see serving/faults.py for the grammar)")
    # observability (docs/observability.md)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose /metrics (Prometheus), /stats (JSON), /trace "
                         "(span ring buffer) and /healthz on this port; 0 binds "
                         "an ephemeral port.  Turns live telemetry on.")
    ap.add_argument("--trace-jsonl", default=None,
                    help="mirror span events to this JSONL file (implies "
                         "live telemetry)")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(f"--arch {args.arch}: {e}")
    try:
        (serve_vggt if cfg.vggt else serve_lm)(cfg, args)
    except (RuntimeError, ValueError, OSError, NotImplementedError) as e:
        print(f"serve: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
