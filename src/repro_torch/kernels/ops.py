"""Public wrappers around the CUDA kernels (port of ``repro/kernels/ops.py``).

Only the two wrappers the W4A8 VGGT path needs are ported here:
:func:`quant_linear_matmul` and :func:`two_stage_mha`.  The fused-datapath
and WHT wrappers wait for their kernels.

Tile policy.  The TPU wrappers chose tiles per call (``lane_tile`` with
``LANE=8`` sublanes, padding token axes to a tile multiple).  The Hopper
kernels instead use fixed tiles chosen for the card (128x128x64 for the
matmul; 64 query rows x 64 keys, with a 2048-key int32 carry period, for
attention — see ``csrc/``) and mask ragged M/N and Lq/Lk edges inside the
kernel, so the wrappers never pad.  Results for the real rows equal the
padded TPU path's: padded rows are independent per token and padded keys
are masked to ``-1e30`` there.

On CPU tensors the kernel modules run their plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import QTensor, quantize_per_token
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import two_stage_attention as _tsa

__all__ = ["quant_linear_matmul", "two_stage_mha"]


def quant_linear_matmul(x: torch.Tensor, wq: QTensor, a_bits: int = 8) -> torch.Tensor:
    """Quantize activations per token and run the integer matmul kernel.

    x: [..., K] float -> [..., N] float32.
    """
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    n = wq.shape[-1]
    xq = quantize_per_token(x.reshape(-1, k), a_bits)
    y = _qm.quant_matmul(
        xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1).to(torch.float32),
        packed=wq.packed,
    )
    return y.reshape(lead + (n,))


def two_stage_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Paper-Alg.-1 attention over float [B, H, L, dh] inputs.

    Quantizes Q/K per token and V per head to int8, then runs the
    two-stage kernel.  K/V may carry fewer (GQA-shared) heads than Q
    ([B, Hkv, Lk, dh]); shared heads are indexed inside the kernel, never
    copied.  ``v_scale`` stays per *query* head, exactly as the reference
    keeps it.  Returns [B, H, Lq, dh] float32.
    """
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not share {hkv} K/V heads evenly")
    qf = q.reshape(b * h, lq, dh)
    kf = k.reshape(b * hkv, lk, dh)
    vf = v.reshape(b * hkv, lk, dh)
    qq = quantize_per_token(qf, 8)
    kq = quantize_per_token(kf, 8)
    vmax = vf.abs().amax(dim=(1, 2), keepdim=True)
    vscale = torch.clamp_min(vmax, 1e-8) / 127.0
    vv = torch.round(vf / vscale).clamp(-127, 127).to(torch.int8)
    vscale_q = vscale.reshape(b, hkv, 1, 1).repeat_interleave(h // hkv, dim=1)
    out = _tsa.two_stage_attention(
        qq.values,
        qq.scale.contiguous(),
        kq.values,
        kq.scale.contiguous(),
        vv,
        vscale_q.reshape(b * h, 1, 1).to(torch.float32).contiguous(),
        causal=causal,
        q_heads=h if hkv != h else None,
        kv_heads=hkv if hkv != h else None,
    )
    return out.reshape(b, h, lq, dh)
