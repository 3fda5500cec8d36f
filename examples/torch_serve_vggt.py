"""End-to-end on the PyTorch/CUDA port: feed-forward 3D reconstruction
serving, the paper's deployment (the port of ``examples/serve_vggt.py``).

1. Train a VGGT-mini on synthetic multi-view scenes (a few hundred steps).
2. Quantize it W4A8 with the calibration-free VersaQ pipeline, its
   projections routed through the ``quant_matmul`` kernel on the card.
3. Serve batched multi-view requests through ``VGGTEngine`` (shape
   buckets, a micro-batched scene queue), fp and W4A8 engines compared on
   fidelity, bytes and per-bucket latency stats.  ``--attn-impl
   two_stage`` runs the quantized engine's attention through the INT8
   two-stage kernel.

It runs on the CUDA device unless ``--device cpu`` is given (each kernel
wrapper then takes its plain PyTorch version).

Run:  PYTHONPATH=src python examples/torch_serve_vggt.py [--steps 200] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import scene_batch
from repro_torch.models import vggt
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import make_train_step
from repro_torch.serving.batching import resolve_device
from repro_torch.serving.vggt_engine import VGGTEngine
from repro_torch.tree import tree_leaves


def tree_bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(t))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--patches", type=int, default=64)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--attn-impl", default=None,
                    help="quantized engine attention (two_stage = the INT8 CUDA kernel)")
    ap.add_argument("--device", default="cuda",
                    help="where to train and serve (default: the CUDA device; no fallback)")
    args = ap.parse_args()

    dev = resolve_device(args.device, "torch_serve_vggt")
    cfg = get_config("vggt-1b-smoke").with_(layerscale_init=0.2)
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    opt = adamw.init(params)
    step = make_train_step(cfg, opt_cfg, lambda p, b: vggt.reconstruction_loss(cfg, p, b))

    print(f"training VGGT-mini for {args.steps} steps on synthetic scenes...")
    for s in range(args.steps):
        params, opt, m = step(params, opt,
                              scene_batch(4, args.frames, args.patches, cfg.d_model, s))
        if s % 50 == 0:
            print(f"  step {s:4d} loss {float(m['loss']):.4f}")
    print(f"  final loss {float(m['loss']):.4f}")

    # fp and W4A8 serving engines over the same trained weights
    fp_eng = VGGTEngine(cfg, params, max_batch=8, device=dev)
    q_eng = VGGTEngine(cfg, params, policy=PrecisionPlan(default="w4a8", use_kernel=True),
                       attn_impl=args.attn_impl, max_batch=8, device=dev)
    print(f"model bytes: fp={tree_bytes(fp_eng.params)/1e6:.1f}MB "
          f"quantized={tree_bytes(q_eng.params)/1e6:.1f}MB")

    # micro-batched serving: several small scene requests coalesce into one
    # bucketed forward per engine; repeat traffic reuses the bucket
    for wave in range(args.requests):
        reqs = [
            (eng, eng.enqueue(scene_batch(4, args.frames, args.patches, cfg.d_model,
                                          10_000 + 10 * wave + i)["patches"]))
            for i in range(2)
            for eng in (q_eng, fp_eng)
        ]
        q_eng.flush()
        fp_eng.flush()
        quant = [r.result() for e, r in reqs if e is q_eng]
        ref = [r.result() for e, r in reqs if e is fp_eng]
        rel = sum(float(torch.linalg.norm(a["points"] - b["points"])
                        / torch.linalg.norm(b["points"])) for a, b in zip(quant, ref)) / len(ref)
        print(f"wave {wave}: {sum(r.result()['pose'].shape[0] for _, r in reqs) // 2} scenes "
              f"x {args.frames} views; quant-vs-fp rel err {rel:.4f}")

    print("\nW4A8 engine per-bucket stats:")
    print(q_eng.stats.format())
    print("\nfp engine:")
    print(fp_eng.stats.format())


if __name__ == "__main__":
    main()
