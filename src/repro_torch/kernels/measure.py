"""Measurement helpers for the card, shared by ``chip_smoke.py`` and
``tools/time_kernel_sources.py``: CUDA-event timing with the L2 flushed,
the two-stage attention kernel's inputs at a given shape and the count of
its int8 probabilities that differ from the plain version's, and the
fused FFN's inputs.  Nothing on the model path imports this module.
"""
from __future__ import annotations

import ctypes
import math
import statistics

import torch

from repro_torch.core.quantize import quantize_per_token, quantize_weight
from repro_torch.kernels import two_stage_attention as tsa

__all__ = ["time_ms", "kernel_attrs", "attention_inputs", "pq_flips", "ffn_inputs",
           "fused_matmul_inputs"]


# cycles of the spin kernel that holds the device between the flush and the
# start event (~0.5 ms at the H100's clocks)
SPIN_CYCLES = 1_000_000


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs; a 64 MB buffer is
    rewritten before each run so no input stays in the 50 MB L2.  A spin
    kernel then holds the device while the host enqueues ``fn`` (a
    wrapper's argument checks and allocations), so the window holds device
    time only, unless ``fn`` waits on the device itself."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_attrs(lib: ctypes.CDLL, kernel: str, *args) -> dict:
    """A kernel's resources from ``vq_<kernel>_attrs(args..., int out[4])``
    of a loaded library (ints, and floats passed as C floats): registers
    per thread, shared memory per block in bytes, resident blocks per SM
    and spilled bytes per thread."""
    fn = getattr(lib, f"vq_{kernel}_attrs")
    fn.argtypes = [ctypes.c_float if isinstance(a, float) else ctypes.c_int for a in args]
    fn.argtypes += [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"vq_{kernel}_attrs: cudaError {rc}")
    return {"registers": out[0], "smem_per_block": out[1], "blocks_per_sm": out[2],
            "spill_bytes": out[3]}


def attention_inputs(randn, b: int, hq: int, hkv: int, length: int, dh: int,
                     lk: int | None = None):
    """Quantized inputs of one two-stage attention call with Lq =
    ``length`` and Lk = ``lk`` (default: ``length``), drawn from
    ``randn(*shape)``: per-token int8 Q and K, V in int8 with one scale per
    K/V head.  Returns ``(args, gqa, vscale)``: the kernel's positional
    arguments, its GQA keywords (empty when ``hq == hkv``) and the
    per-K/V-head scale of V, shaped [B*hkv, 1, 1]."""
    lk = length if lk is None else lk
    q, k, v = randn(b * hq, length, dh), randn(b * hkv, lk, dh), randn(b * hkv, lk, dh)
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


def ffn_inputs(randn, m: int, d: int, dff: int, *, w_bits: int = 4, a_bits: int = 8,
               a_bits_mid: int | None = None, gated: bool = False, norm: str | None = "ln",
               pro_wht: bool = False):
    """One fused FFN call at [M, D] -> d_ff -> D with biases, drawn from
    ``randn(*shape)``: weights scaled by 1/sqrt(fan-in) and quantized to
    ``w_bits`` (4: packed), the input quantized to ``a_bits`` and the
    hidden to ``a_bits_mid`` (default: ``a_bits``), GELU (SiLU when gated),
    the hidden WHT over 4096 where d_ff allows it (else its largest
    power-of-two factor), the 64-block IDCT on the hidden and the output.  Returns ``(args, kw)`` for
    :func:`repro_torch.kernels.fused.fused_ffn`."""
    from repro_torch.core.versaq import make_folded_norm

    wu = quantize_weight(randn(d, dff) / math.sqrt(d), w_bits)
    wd = quantize_weight(randn(dff, d) / math.sqrt(dff), w_bits)
    wg = quantize_weight(randn(d, dff) / math.sqrt(d), w_bits) if gated else None
    x = randn(m, d)
    u = make_folded_norm("ln", d, device=x.device).u if norm == "ln" else None
    args = (x, wu.values, wu.scale.reshape(1, -1).contiguous(), wd.values,
            wd.scale.reshape(1, -1).contiguous(), None if wg is None else wg.values,
            None if wg is None else wg.scale.reshape(1, -1).contiguous(), None, randn(dff),
            randn(d), u)
    packed = w_bits == 4
    kw = dict(packed_g=gated and packed, packed_u=packed, packed_d=packed, a_bits_in=a_bits,
              a_bits_mid=a_bits if a_bits_mid is None else a_bits_mid, norm_kind=norm,
              act="silu" if gated else "gelu",
              pro_wht_block=d if pro_wht else None,
              mid_wht_block=4096 if dff % 4096 == 0 else dff & -dff, idct_h=True,
              idct_out=True, dct_block=64)
    return args, kw


def fused_matmul_inputs(randn, m: int, k: int, n: int, *, norm: str | None = "ln"):
    """One served-style fused linear call, [M, K] f32 -> [M, N], drawn from
    ``randn(*shape)``: packed W4 weights scaled by 1/sqrt(K), A8, the
    ``norm`` prologue (``ln`` with its mean-recovery vector), the 64-block
    IDCT and a bias.  Returns ``(args, kw)`` for
    :func:`repro_torch.kernels.fused.fused_matmul`."""
    from repro_torch.core.versaq import make_folded_norm

    wq = quantize_weight(randn(k, n) / math.sqrt(k), 4)
    x = randn(m, k)
    u = make_folded_norm("ln", k, device=x.device).u if norm == "ln" else None
    args = (x, wq.values, wq.scale.reshape(1, -1).contiguous(), None, randn(n), u)
    return args, dict(packed=True, a_bits=8, norm_kind=norm, dct_block=64)
