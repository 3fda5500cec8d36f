"""Quickstart on the PyTorch/CUDA port: VersaQ-3D quantization in 60 lines
(the port of ``examples/quickstart.py``).

Builds a small qwen3-family model, trains it briefly, quantizes it with
the paper's calibration-free WHT+DCT pipeline at W4A8, and shows (a)
computational invariance of the transform pipeline and (b) the accuracy
ordering VersaQ > QuaRot > RTN under the paper's activation premises.

It runs on the CUDA device unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--steps 80] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.versaq import W4A8, QuantPolicy
from repro_torch.data.pipeline import DataConfig, token_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import make_train_step
from repro_torch.serving.batching import resolve_device


def rel_err(out, ref) -> float:
    return float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="where to train and quantize (default: the CUDA device; no fallback)")
    args = ap.parse_args()

    dev = resolve_device(args.device, "torch_quickstart")
    cfg = get_config("qwen3-14b-smoke")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    # brief training so the model has real structure (random logits make
    # greedy agreement meaningless)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=32)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                  total_steps=args.steps))
    opt = adamw.init(params)
    for s in range(args.steps):
        params, opt, m = step(params, opt, token_batch(dc, s))
    print(f"trained {args.steps} steps, loss {float(m['loss']):.3f}")

    toks = torch.as_tensor(token_batch(dc, 999)["tokens"][:2], device=dev)
    with torch.no_grad():
        ref, _ = lm.forward(cfg, params, toks)

        # 1. the transform pipeline alone is exact (computational invariance)
        out, _ = lm.forward(cfg, quantize_lm(cfg, params, QuantPolicy(16, 16, "versaq")), toks)
        print(f"invariance rel err (16-bit 'lossless'): {rel_err(out, ref):.2e}")

        # 2. real quantization: W4A8, calibration-free
        out, _ = lm.forward(cfg, quantize_lm(cfg, params, W4A8), toks)
        agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"W4A8 greedy-token agreement with fp: {agree*100:.1f}%")

        # 3. method comparison at W4A4
        for method in ("rtn", "quarot", "versaq"):
            out, _ = lm.forward(cfg, quantize_lm(cfg, params, QuantPolicy(4, 4, method)), toks)
            print(f"W4A4 {method:7s} logits rel err: {rel_err(out, ref):.4f}")


if __name__ == "__main__":
    main()
