"""Mixed-precision VGGT serving on the PyTorch/CUDA port: plan, inspect,
serve per tier (the port of ``examples/mixed_precision.py``).

The paper's reconfigurable accelerator runs BF16/INT8/INT4 side by side;
this example is that story end to end on a tiny VGGT:

1. **Plan** — the calibration-free sensitivity planner scores every
   weight site on synthetic saturated-channel activations and assigns
   bits greedily under a modeled weight-bytes + latency budget
   (``repro_torch/core/precision/planner.py``).
2. **Inspect** — print the per-site bit map and the modeled budgets.
3. **Serve** — one ``VGGTEngine`` serves three precision tiers
   (``quality``=fp, ``balanced``=uniform W4A8, ``fast``=the planned mixed
   plan), each tier with its own buckets; one scene is served per tier and
   compared against fp.

It runs on the CUDA device unless ``--device cpu`` is given (each kernel
wrapper then takes its plain PyTorch version).

Run:  PYTHONPATH=src python examples/torch_mixed_precision.py [--frames 4] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import plan_model, proxy_recon_error, uniform_weight_bytes
from repro_torch.core.versaq import W4A4, W4A8
from repro_torch.data.pipeline import scene_batch
from repro_torch.models import vggt
from repro_torch.serving.batching import resolve_device
from repro_torch.serving.vggt_engine import VGGTEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--patches", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=4096,
                    help="reference token batch for the latency model")
    ap.add_argument("--device", default="cuda",
                    help="where to plan and serve (default: the CUDA device; no fallback)")
    args = ap.parse_args()

    dev = resolve_device(args.device, "torch_mixed_precision")
    cfg = get_config("vggt-1b-smoke")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    # 1. plan under the default budgets: weight bytes capped at uniform
    #    W4A4, modeled latency at 1.25x the all-INT4 baseline
    plan, report = plan_model(cfg, params, tokens=args.tokens)
    print("per-site bit map (sensitivity-planned):")
    for site, level in sorted(report["assignment"].items()):
        err = report["site_errors"][site][level]
        print(f"  {site:24s} {level:5s}  (site err {err:.4f})")
    print(f"levels: {report['level_counts']}")
    w4a4_bytes = uniform_weight_bytes(cfg, params, "w4a4")
    print(f"modeled weight bytes: plan={report['weight_bytes']:.0f} "
          f"uniform-w4a4={w4a4_bytes:.0f}")
    print(f"modeled latency: {report['modeled_latency_s']*1e6:.2f}us "
          f"(budget {report['latency_budget_s']*1e6:.2f}us)")
    print(f"plan json:\n{plan.to_json()}")

    # proxy quality: the mixed plan must beat uniform W4A4 at equal bytes
    e_plan = proxy_recon_error(cfg, params, plan)
    e_w4a4 = proxy_recon_error(cfg, params, W4A4)
    e_w4a8 = proxy_recon_error(cfg, params, W4A8)
    print(f"proxy recon err: planned={e_plan:.5f} w4a4={e_w4a4:.5f} "
          f"w4a8={e_w4a8:.5f} (plan beats w4a4: {e_plan < e_w4a4})")

    # 3. one engine, three precision tiers
    eng = VGGTEngine(cfg, params, tiers={"quality": None, "balanced": W4A8, "fast": plan},
                     device=dev)
    scenes = torch.as_tensor(
        scene_batch(1, args.frames, args.patches, cfg.d_model, 7)["patches"], device=dev)
    ref = eng.infer(scenes, tier="quality")
    for tier in ("quality", "balanced", "fast"):
        out = eng.infer(scenes, tier=tier)
        rel = float(torch.linalg.norm(out["points"] - ref["points"])
                    / (torch.linalg.norm(ref["points"]) + 1e-9))
        print(f"tier {tier:9s} points vs quality rel err {rel:.5f}")
    print("\nper-tier bucket stats (1 first use per tier bucket):")
    print(eng.stats.format())


if __name__ == "__main__":
    main()
