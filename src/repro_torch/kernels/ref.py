"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``).

Each is the reference's oracle op for op, kept apart from the kernels'
plain versions (``quant_matmul_plain``, ``two_stage_attention_plain``, ...),
which follow the CUDA kernels' own op order.  One convention differs from
the kernels on purpose, as in the reference: these oracles mask causal
attention bottom-right aligned (``tril(k=Lk-Lq)``), the kernels top-left
(``rows >= cols``); the two agree only at ``Lq == Lk``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import transforms
from repro_torch.core.quantize import unpack_int4

__all__ = [
    "quant_matmul_ref",
    "attention_ref",
    "two_stage_attention_ref",
    "wht_ref",
]


def quant_matmul_ref(xv, xs, wv, ws, *, packed: bool, out_dtype=torch.float32):
    """Oracle for the integer matmul: exact integer accumulate, then scale.

    xv [M,K] int8, xs [M,1] f32, wv [K,N] int8 (or [K//2,N] uint8 packed),
    ws [1,N] f32.  The sum is taken in float64, which holds every int8
    product sum exactly, as the reference's int32 dot does."""
    if packed:
        wv = unpack_int4(wv, axis=0)
    acc = xv.to(torch.float64) @ wv.to(torch.float64)
    return (acc.to(torch.float32) * xs * ws).to(out_dtype)


def _causal_mask(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones((lq, lk), dtype=torch.bool, device=device).tril(diagonal=lk - lq)


def attention_ref(q, k, v, *, causal: bool, scale: float | None = None):
    """FP softmax attention oracle. q,k,v: [..., L, dh] float."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32), k.to(torch.float32)) * scale
    if causal:
        s = torch.where(_causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        torch.tensor(-math.inf, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("...qk,...kd->...qd", p, v.to(torch.float32))


def two_stage_attention_ref(qv, qs, kv, ks, vv, vs, *, causal: bool, scale: float | None = None):
    """Oracle for the INT two-stage kernel (paper Alg. 1), including the
    INT8 re-quantization of the softmax probabilities (Alg. 1 line 11).

    qv/kv/vv: [..., L, dh] int8; qs/ks: per-token scales [..., L, 1] f32;
    vs: per-tensor (per-head) scalar scale.  Integer dot first, scales
    after, as in the kernels."""
    dh = qv.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s_int = torch.einsum("...qd,...kd->...qk", qv.to(torch.float64),
                         kv.to(torch.float64)).to(torch.float32)
    s = s_int * qs * ks.transpose(-1, -2) * scale
    if causal:
        s = torch.where(_causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        torch.tensor(-math.inf, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pq = torch.round(p * 127.0)
    o = torch.einsum("...qk,...kd->...qd", pq.to(torch.float64),
                     vv.to(torch.float64)).to(torch.float32)
    return o * (vs / 127.0) / l


def wht_ref(x):
    """Blocked Walsh-Hadamard transform oracle (dense matmul)."""
    hb = transforms.blocked_hadamard_matrix(x.shape[-1], device=x.device)
    return (x.to(torch.float32) @ hb).to(x.dtype)
