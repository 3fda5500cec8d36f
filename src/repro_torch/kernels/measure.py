"""Measurement helpers for the card, shared by ``chip_smoke.py`` and
``tools/time_attention_sources.py``: CUDA-event timing with the L2 flushed,
the two-stage attention kernel's inputs at a given shape, and the count of
its int8 probabilities that differ from the plain version's.  Nothing on
the model path imports this module.
"""
from __future__ import annotations

import statistics

import torch

from repro_torch.core.quantize import quantize_per_token
from repro_torch.kernels import two_stage_attention as tsa

__all__ = ["time_ms", "attention_inputs", "pq_flips"]


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs; a 64 MB buffer is
    rewritten before each run so no input stays in the 50 MB L2."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(randn, b: int, hq: int, hkv: int, length: int, dh: int):
    """Quantized inputs of one two-stage attention call with Lq = Lk =
    ``length``, drawn from ``randn(*shape)``: per-token int8 Q and K, V in
    int8 with one scale per K/V head.  Returns ``(args, gqa, vscale)``:
    the kernel's positional arguments, its GQA keywords (empty when
    ``hq == hkv``) and the per-K/V-head scale of V, shaped [B*hkv, 1, 1]."""
    q, k, v = randn(b * hq, length, dh), randn(b * hkv, length, dh), randn(b * hkv, length, dh)
    qq, kq = quantize_per_token(q, 8), quantize_per_token(k, 8)
    vscale = torch.clamp_min(v.abs().amax(dim=(1, 2), keepdim=True), 1e-8) / 127.0
    vv = torch.round(v / vscale).clamp(-127, 127).to(torch.int8)
    vsq = vscale.reshape(b, hkv).repeat_interleave(hq // hkv, dim=1).reshape(b * hq, 1, 1)
    gqa = dict(q_heads=hq, kv_heads=hkv) if hq != hkv else {}
    return (qq.values, qq.scale, kq.values, kq.scale, vv, vsq.contiguous()), gqa, vscale


def pq_flips(args, attention=tsa.two_stage_attention) -> tuple[int, int]:
    """Int8 probabilities ``pq`` of ``attention`` (by default the kernel's
    wrapper) that differ from the plain version's, over the first head of
    ``args`` (no GQA).  Head w of one
    launch reads V = 127 on the diagonal of keys w*dh .. w*dh + dh - 1 and
    0 elsewhere, with v_scale 1/127, so out[w, r, j] = pq[r, w*dh + j] /
    (127 l_r): a pq that differs moves its entry by at least 1/127
    relative, a different rounding of l by ~1e-6.  Returns (differing, all)."""
    qv, qs, kv, ks = (a[:1] for a in args[:4])
    lq, lk, dh = qv.shape[1], kv.shape[1], qv.shape[2]
    nw = -(-lk // dh)
    keys = torch.arange(lk, device=qv.device)
    vv = torch.zeros((nw, lk, dh), dtype=torch.int8, device=qv.device)
    vv[keys // dh, keys, keys % dh] = 127

    def rep(x):
        return x.expand(nw, *x.shape[1:]).contiguous()

    a = (rep(qv), rep(qs), rep(kv), rep(ks), vv,
         torch.full((nw, 1, 1), 1 / 127, device=qv.device))
    got = attention(*a)
    want = tsa.two_stage_attention_plain(*a)
    differ = (got - want).abs() > 1e-3 * torch.maximum(got.abs(), want.abs())
    return int(differ.sum()), lq * lk
