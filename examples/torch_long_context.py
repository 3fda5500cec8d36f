"""Long-context decode with sub-quadratic architectures (rwkv6 / jamba) on
the PyTorch/CUDA port (the port of ``examples/long_context.py``).

Shows the O(1)-state property: rwkv6's decode latency and cache are flat
in the context length, while jamba's attention layers keep an int8 KV
cache (with per-token f32 scales) that grows with it, half the bytes of a
bf16 one.  For each model and context: a 64-token prefill through
``lm.forward(mode="prefill")``, then 16 timed ``lm.decode_step`` calls
(after one untimed); it prints ms a token and the cache bytes.  The cache
bytes are those of the cache's tensors (int8 KV and scales, f32 recurrent
states); the write positions are host ints here, where the reference keeps
them as int32 device scalars.

It runs on the CUDA device unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_long_context.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving.batching import resolve_device
from repro_torch.tree import tree_leaves

ARCHS = ("rwkv6-1.6b-smoke", "jamba-v0.1-52b-smoke")
CONTEXTS = (128, 512, 2048)
PROMPT, DECODE = 64, 16


def cache_bytes(cache) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))


def kv_bytes(cfg, ctx: int, kv_dtype) -> int:
    """Bytes of the K/V tensors alone (no scales) of a ``ctx``-token cache."""
    cache = lm.init_cache(cfg, 1, ctx, kv_dtype=kv_dtype, device="meta")
    entries = [e for e in list(cache["blocks"].values()) + cache["prefix"]
               if e is not None and hasattr(e, "k_scale")]
    return sum(t.numel() * t.element_size() for e in entries for t in (e.k, e.v))


@torch.inference_mode()
def measure(cfg, params, ctx: int, device) -> tuple[float, int]:
    """(ms a decode token, cache bytes after a ``PROMPT``-token prefill and
    ``DECODE`` timed decode steps)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = lm.init_cache(cfg, 1, ctx, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device=dev)
    _, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill")
    tok = torch.zeros((1,), dtype=torch.long, device=dev)
    _, cache = lm.decode_step(cfg, params, tok, cache)  # warm-up, untimed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(DECODE):
        logits, cache = lm.decode_step(cfg, params, tok, cache)
        tok = torch.argmax(logits[:, 0], dim=-1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / DECODE * 1e3, cache_bytes(cache)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where to run (default: the CUDA device; no fallback)")
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_long_context")
    for arch in ARCHS:
        cfg = get_config(arch)
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        print(f"\n=== {arch} ===")
        for ctx in CONTEXTS:
            ms, nbytes = measure(cfg, params, ctx, dev)
            line = (f"  ctx={ctx:5d}: {ms:6.1f} ms/token, cache {nbytes / 1e6:.2f} MB "
                    f"(int8 KV + f32 states)")
            if "attn" in cfg.pattern:
                line += (f"; K/V int8 {kv_bytes(cfg, ctx, torch.int8) / 1e6:.2f} MB vs bf16 "
                         f"{kv_bytes(cfg, ctx, torch.bfloat16) / 1e6:.2f} MB")
            print(line)


if __name__ == "__main__":
    main()
