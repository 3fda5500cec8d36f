"""Public wrappers around the CUDA kernels (port of ``repro/kernels/ops.py``).

The unfused W4A8 path's :func:`quant_linear_matmul` and
:func:`two_stage_mha`; the unified datapath's :func:`fused_linear`,
:func:`fused_ffn_apply` and :func:`norm_quant_prologue`; and
:func:`online_wht_2d`.

Tile policy.  The TPU wrappers chose tiles per call (``lane_tile`` with
``LANE=8`` sublanes, padding token axes to a tile multiple).  The Hopper
kernels instead use fixed tiles chosen for the card (128x128x64 for the
matmul; 64 query rows x 64 keys, with a 2048-key int32 carry period, for
attention; 64-row tiles and 128-column N tiles for the fused kernels — see
``csrc/``) and mask ragged M/N and Lq/Lk edges inside the kernel, so the
wrappers never pad.  Results for the real rows equal the
padded TPU path's: padded rows are independent per token and padded keys
are masked to ``-1e30`` there.

On CPU tensors the kernel modules run their plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.core import transforms
from repro_torch.core.quantize import QTensor, quantize_per_token
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import two_stage_attention as _tsa
from repro_torch.kernels import wht as _wht

__all__ = [
    "quant_linear_matmul",
    "two_stage_mha",
    "online_wht_2d",
    "fused_linear",
    "fused_ffn_apply",
    "norm_quant_prologue",
]


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


def online_wht_2d(x: torch.Tensor, **kw) -> torch.Tensor:
    """Blocked WHT kernel along the last axis of float [..., d]."""
    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    return _wht.wht(x.reshape(-1, d), **kw).reshape(lead + (d,))


# ---------------------------------------------------------------------------
# unified-datapath wrappers (kernels/fused.py)
# ---------------------------------------------------------------------------


def _wht_block(on: bool, width: int):
    return transforms.block_size_for(width) if on else None


def fused_linear(x, p):
    """One-launch QuantLinear apply: prologue (norm → WHT → quantize) +
    integer matmul + epilogue (IDCT → bias → act → WHT → requant), driven
    by the layer's ``prologue``/``epilogue`` descriptors
    (``core.versaq.QuantLinear``).

    ``x``: float [..., K], or a pre-quantized ``QTensor`` (e.g. from
    :func:`norm_quant_prologue`, shared across several projections).
    Returns float32 [..., N], or a per-token-scaled ``QTensor`` when the
    epilogue requantizes.
    """
    pro, epi = p.prologue, p.epilogue
    prequant = isinstance(x, QTensor)
    src = x.values if prequant else x
    lead = tuple(src.shape[:-1])
    k = src.shape[-1]
    n = p.qw.shape[-1]
    requant = epi.requant_bits if epi is not None else None
    out = _fused.fused_matmul(
        src.reshape(-1, k) if prequant else src.reshape(-1, k).to(torch.float32),
        p.qw.values,
        p.qw.scale.reshape(1, -1),
        xs=x.scale.reshape(-1, 1) if prequant else None,
        bias=p.bias,
        norm_u=p.norm_u,
        packed=p.qw.packed,
        a_bits=p.a_bits,
        norm_kind=pro.norm if (pro is not None and not prequant) else None,
        norm_eps=pro.eps if pro is not None else 1e-6,
        pro_wht_block=_wht_block(p.rotate_input and not prequant, k),
        act=epi.act if epi is not None else "none",
        epi_wht_block=_wht_block(epi is not None and epi.wht, n),
        requant_bits=requant,
        dct_block=p.dct_block if p.idct else None,
    )
    if requant is not None:
        qv, qs = out
        return QTensor(values=qv.reshape(lead + (n,)), scale=qs.reshape(lead + (1,)),
                       bits=requant)
    return out.reshape(lead + (n,))


def fused_ffn_apply(x: torch.Tensor, f) -> torch.Tensor:
    """The whole gated/plain FFN layer in ONE launch
    (``core.versaq.FusedFFN``): norm prologue → shared A-quant → gate/up
    int matmuls → act·gate → hidden WHT → requant → down int matmul →
    IDCT/biases.  x: float [..., D] -> float32 [..., d_out]."""
    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    wu, wd, wg = f.w_up, f.w_down, f.w_gate
    dff = wu.qw.shape[-1]
    n_out = wd.qw.shape[-1]
    y = _fused.fused_ffn(
        x.reshape(-1, d).to(torch.float32),
        wu.qw.values,
        wu.qw.scale.reshape(1, -1),
        wd.qw.values,
        wd.qw.scale.reshape(1, -1),
        wg=None if wg is None else wg.qw.values,
        wgs=None if wg is None else wg.qw.scale.reshape(1, -1),
        bg=None if wg is None else wg.bias,
        bu=wu.bias,
        bd=wd.bias,
        norm_u=f.norm_u,
        packed_g=bool(wg is not None and wg.qw.packed),
        packed_u=wu.qw.packed,
        packed_d=wd.qw.packed,
        a_bits_in=wu.a_bits,
        a_bits_mid=wd.a_bits,
        norm_kind=f.norm,
        norm_eps=f.norm_eps,
        act=f.act,
        # unrotated-stream flows carry the online WHT on the gate/up inputs
        pro_wht_block=_wht_block(wu.rotate_input, d),
        mid_wht_block=_wht_block(wd.rotate_input, dff),
        idct_h=wu.idct,
        idct_out=wd.idct,
        dct_block=wu.dct_block if (wu.idct or wd.idct) else None,
    )
    return y.reshape(lead + (n_out,))


def norm_quant_prologue(
    x: torch.Tensor,
    *,
    norm: str | None = None,
    norm_u: torch.Tensor | None = None,
    eps: float = 1e-6,
    wht: bool = False,
    a_bits: int = 8,
) -> QTensor:
    """Fused prologue over float [..., D]: folded-norm statistics →
    blocked WHT → per-token quantization, one launch.  Returns a
    per-token-scaled ``QTensor`` ready for :func:`fused_linear` (share it
    across co-located projections, e.g. Q/K/V)."""
    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    qv, qs = _fused.norm_quant(
        x.reshape(-1, d).to(torch.float32),
        norm_u=norm_u,
        norm_kind=norm,
        norm_eps=eps,
        wht_block=_wht_block(wht, d),
        a_bits=a_bits,
    )
    return QTensor(values=qv.reshape(lead + (d,)), scale=qs.reshape(lead + (1,)), bits=a_bits)
