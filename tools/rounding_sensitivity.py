#!/usr/bin/env python3
"""How far float rounding moves a fused forward, against each kernel call's own error.

Run from the repository root (on the card, or on the CPU, where every
kernel wrapper runs its plain version and the first two readings are 0):

    PYTHONPATH=src python3 tools/rounding_sensitivity.py [--trials 8] [--noise 1e-7]

It serves the masked bucket of ``tests/test_torch_cuda.py::
test_fused_engine_serves_masked_bucket`` (vggt-1b-smoke with LayerScale
0.2, the fused W4A8 plan, 2 scenes x 2 frames x 20 of 32 patches) and
prints:

1. each ``fused_matmul`` and ``fused_ffn`` call of the served forward: its
   relative L2 error against its plain version on the same inputs;
2. the served outputs against a forward of the same padded, masked batch
   with the plain versions;
3. ``trials`` forwards with the plain versions whose every fused output is
   scaled by ``1 + noise * N(0, 1)``, each against the unperturbed one.

Where 3 moves the outputs as much as 2 does, the outputs' distance from the
plain forward is a rounding flip of a quantized activation, amplified by
the model, not a kernel's error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("pose", "points", "depth")
PATCHES, PADDED = 20, 32


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--noise", type=float, default=1e-7)
    return ap.parse_args(argv)


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def run(trials: int, noise: float) -> dict:
    """The three readings: ``calls`` [(kernel, rel)], ``served`` {key: rel}
    and ``perturbed`` [{key: rel}] per trial."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.kernels import fused as fz
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cfg = get_config("vggt-1b-smoke").with_(layerscale_init=0.2)
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = VGGTEngine(cfg, params, policy=PrecisionPlan(default="w4a8", fuse=True),
                     attn_impl="two_stage", batch_buckets=(2,), max_batch=2, pad_patches=True,
                     device=dev)
    rng = np.random.default_rng(9)
    scenes = torch.as_tensor(rng.normal(size=(2, 2, PATCHES, cfg.d_model)).astype(np.float32),
                             device=dev)
    names = ("fused_matmul", "fused_ffn")
    kernel = {n: getattr(fz, n) for n in names}
    plain = {n: getattr(fz, f"{n}_plain") for n in names}
    calls = []

    def held(n):
        def call(*a, **kw):
            out = kernel[n](*a, **kw)
            calls.append((n, _rel(out, plain[n](*a, **kw))))
            return out
        return call

    gen = torch.Generator(device=dev).manual_seed(5)

    def perturbed(n):
        def call(*a, **kw):
            out = plain[n](*a, **kw)
            return out * (1 + noise * torch.randn(out.shape, generator=gen, device=dev))
        return call

    def forward_with(wrap, fn):
        for n in names:
            setattr(fz, n, wrap(n))
        try:
            with torch.inference_mode():
                return fn()
        finally:
            for n in names:
                setattr(fz, n, kernel[n])

    got = forward_with(held, lambda: eng.infer(scenes))
    padded = torch.nn.functional.pad(scenes, (0, 0, 0, PADDED - PATCHES))
    mask = torch.zeros(padded.shape[:3], dtype=torch.bool, device=dev)
    mask[:, :, :PATCHES] = True

    def forward():
        return vggt.forward(eng.cfg, eng.params, padded, patch_mask=mask)

    want = forward_with(lambda n: plain[n], forward)
    served = {k: _rel(got[k], want[k] if k == "pose" else want[k][:, :, :PATCHES]) for k in KEYS}
    pert = [{k: _rel(p[k], want[k]) for k in KEYS}
            for p in (forward_with(perturbed, forward) for _ in range(trials))]
    return {"calls": calls, "served": served, "perturbed": pert, "device": str(dev)}


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    r = run(args.trials, args.noise)
    print(f"device: {r['device']}")
    for name, rel in r["calls"]:
        print(f"  {name}: rel L2 vs its plain version {rel:.3g}")
    print(f"served vs the plain versions' forward: {r['served']}")
    for p in r["perturbed"]:
        print(f"plain versions, outputs x (1 + {args.noise:g} N(0,1)), vs unperturbed: {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
