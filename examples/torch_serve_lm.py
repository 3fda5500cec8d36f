"""End-to-end on the PyTorch/CUDA port: train a tiny LM, quantize it W4A8
and serve it through the async server loop (the port of
``examples/serve_lm.py``).

1. Train a tiny LM on synthetic tokens (a few hundred steps).
2. Quantize it W4A8 with the calibration-free VersaQ pipeline, its
   projections routed through the ``quant_matmul`` kernel on the card.
3. Serve mixed-length prompt traffic through ``serving.engine.Engine``
   behind ``serving.server.AsyncServer``, fp and W4A8 compared on
   greedy-token agreement and per-bucket latency stats.

It runs on the CUDA device unless ``--device cpu`` is given (each kernel
wrapper then takes its plain PyTorch version).

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--steps 200] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import DataConfig, mixed_len_prompts, token_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import make_train_step
from repro_torch.serving.batching import resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import AsyncServer

TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where to train and serve (default: the CUDA device; no fallback)")
    args = ap.parse_args()

    dev = resolve_device(args.device, "torch_serve_lm")
    cfg = get_config("qwen3-14b-smoke").with_(**TINY)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(
        cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps))
    opt = adamw.init(params)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=32)

    print(f"training LM-mini for {args.steps} steps on synthetic tokens...")
    for s in range(args.steps):
        params, opt, m = step(params, opt, token_batch(dc, s))
        if s % 50 == 0:
            print(f"  step {s:4d} loss {float(m['loss']):.4f}")
    print(f"  final loss {float(m['loss']):.4f}")

    max_len = args.prompt_len + args.gen
    fp_eng = Engine(cfg, params, max_len=max_len, max_batch=4, max_wait_s=0.002, device=dev)
    q_eng = Engine(cfg, params, policy=PrecisionPlan(default="w4a8", use_kernel=True),
                   max_len=max_len, max_batch=4, max_wait_s=0.002, device=dev)

    # mixed-length traffic (full and non-pow2 short prompts) through both
    # engines, submitted from the caller thread; the async loop drives
    # deadline flushes so half-full micro-batches still get served
    prompts = mixed_len_prompts(cfg.vocab_size, args.requests, args.prompt_len, seed=10_000)
    with AsyncServer(fp_eng) as fp_srv, AsyncServer(q_eng) as q_srv:
        fp_reqs = [fp_srv.submit(p, args.gen) for p in prompts]
        q_reqs = [q_srv.submit(p, args.gen) for p in prompts]
        fp_out = [np.asarray(fp_srv.result(r, timeout=600)) for r in fp_reqs]
        q_out = [np.asarray(q_srv.result(r, timeout=600)) for r in q_reqs]

    agree = float(np.mean([np.mean(a == b) for a, b in zip(fp_out, q_out)]))
    n_tok = sum(o.shape[-1] for o in fp_out)
    print(f"served {len(prompts)} requests x {args.gen} tokens "
          f"({n_tok} per engine); quant-vs-fp greedy agreement {agree:.3f}")

    print("\nW4A8 engine per-bucket stats:")
    print(q_eng.stats.format())
    print(f"decode throughput: {q_eng.stats.decode_tokens_per_s:.0f} tok/s "
          f"(fp {fp_eng.stats.decode_tokens_per_s:.0f} tok/s)")
    print("\nfp engine:")
    print(fp_eng.stats.format())


if __name__ == "__main__":
    main()
