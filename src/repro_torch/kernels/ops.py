"""Public wrappers around the CUDA kernels (port of ``repro/kernels/ops.py``).

The unfused W4A8 path's :func:`quant_linear_matmul` and
:func:`two_stage_mha`; the unified datapath's :func:`fused_linear`,
:func:`fused_ffn_apply` and :func:`norm_quant_prologue`; and
:func:`online_wht_2d`.

Tiles.  The TPU wrappers chose tiles per call (``lane_tile`` with
``LANE=8`` sublanes, padding token axes to a tile multiple).  Each Hopper
kernel instead launches one fixed tiling chosen for the card and masks
ragged M/N and Lq/Lk edges itself, so the wrappers never pad: 128x256
output tiles with 64 K bytes a step for the matmul
(``quant_matmul.LAUNCH_TILES``); 128 query rows (16 per warp x 8 warps) x
64-key tiles with a 2048-key int32 carry for attention
(``two_stage_attention.LAUNCH_TILES``); 64-row M tiles and 128-column N
tiles for the fused kernels (``fused.MATMUL_TILES``, ``fused.FFN_TILES``).
Results for the real rows equal the padded TPU path's: padded rows are
independent per token and padded keys are masked to ``-1e30`` there.

A compiled ``KernelSchedule`` carries these launch tiles per site
(``QuantLinear.tiles``, ``ModelConfig.attn_tiles``).  The wrappers take
them as ``tiles=`` and raise ``ValueError`` for tiles their kernel cannot
launch (:func:`launch_tiles`) — a schedule compiled for the TPU, say —
rather than ignore them.

On CPU tensors the kernel modules run their plain PyTorch versions.

No kernel has a backward (the reference defines none either), so every
wrapper refuses a tensor that requires grad, on both devices: on the CPU
the plain version would backpropagate while the card's kernel returned a
tensor with no ``grad_fn``.  Serve a trained tree from detached tensors.
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
    "launch_tiles",
    "quant_linear_matmul",
    "two_stage_mha",
    "online_wht_2d",
    "fused_linear",
    "fused_ffn_apply",
    "norm_quant_prologue",
]


# ``quant_matmul``'s batched launch (a MoE layer's routed experts) runs the
# 2-D launch's tiles, one grid plane a problem: it has no entry of its own,
# and a schedule's expert sites carry ``quant_matmul``'s tiles.
_LAUNCH_TILES = {
    "quant_matmul": _qm.LAUNCH_TILES,
    "two_stage_attention": _tsa.LAUNCH_TILES,
    "fused_matmul": _fused.MATMUL_TILES,
    "fused_ffn": _fused.FFN_TILES,
}


def _no_grad(wrapper: str, *tensors) -> None:
    """Raise if any tensor (or a ``QTensor``'s fields) requires grad."""
    for t in tensors:
        leaves = (t.values, t.scale) if isinstance(t, QTensor) else (t,)
        if any(isinstance(x, torch.Tensor) and x.requires_grad for x in leaves):
            raise RuntimeError(
                f"{wrapper}: got a tensor that requires grad, but no kernel has a backward "
                "(the reference defines none); detach the inputs and parameters first")


def launch_tiles(kernel: str, tiles=None) -> dict[str, int]:
    """The tiles ``kernel``'s CUDA kernel launches with.  ``tiles`` (a dict
    or a schedule's ``(name, size)`` pairs) may name any of them at their
    launch size; any other name or size raises ``ValueError``."""
    fixed = _LAUNCH_TILES[kernel]
    if tiles:
        asked = dict(tiles)
        bad = {k: v for k, v in asked.items() if fixed.get(k) != v}
        if bad:
            raise ValueError(
                f"{kernel}: cannot launch tiles {bad}; its kernel launches {fixed} "
                "(recompile the schedule with repro_torch.launch.compile)"
            )
    return dict(fixed)


def quant_linear_matmul(
    x: torch.Tensor, wq: QTensor, a_bits: int = 8, *, tiles=None
) -> torch.Tensor:
    """Quantize activations per token and run the integer matmul kernel.

    x: [..., K] float -> [..., N] float32.  ``tiles``: see :func:`launch_tiles`.

    Expert-stacked weights (values [E, K(/2), N], scales [E, 1, N]: a MoE
    layer's routed experts) take x [..., E, M, K], quantize every row at
    once and make one batched launch over all of x's [E, M] problems (the
    reference's ``vmap`` over the kernel; leading axes of x beyond E are
    dispatch blocks sharing the same experts).
    """
    _no_grad("quant_linear_matmul", x, wq)
    launch_tiles("quant_matmul", tiles)
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    n = wq.values.shape[-1]
    if wq.values.ndim == 3:
        e = wq.values.shape[0]
        xq = quantize_per_token(x.reshape(-1, x.shape[-2], k), a_bits)
        y = _qm.quant_matmul_batched(
            xq.values, xq.scale, wq.values, wq.scale.reshape(e, 1, n).to(torch.float32),
            packed=wq.packed,
        )
        return y.reshape(lead + (n,))
    xq = quantize_per_token(x.reshape(-1, k), a_bits)
    y = _qm.quant_matmul(
        xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1).to(torch.float32),
        packed=wq.packed,
    )
    return y.reshape(lead + (n,))


def two_stage_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, tiles=None
) -> torch.Tensor:
    """Paper-Alg.-1 attention over float [B, H, L, dh] inputs.

    Quantizes Q/K per token and V per head to int8, then runs the
    two-stage kernel.  K/V may carry fewer (GQA-shared) heads than Q
    ([B, Hkv, Lk, dh]); shared heads are indexed inside the kernel, never
    copied.  ``v_scale`` stays per *query* head, exactly as the reference
    keeps it.  Returns [B, H, Lq, dh] float32.  ``tiles``: see
    :func:`launch_tiles`.
    """
    _no_grad("two_stage_mha", q, k, v)
    launch_tiles("two_stage_attention", tiles)
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not share {hkv} K/V heads evenly")
    # contiguous: with b = 1 the reshape of a head-transposed view stays a
    # strided view, and the quantized values keep its strides
    qf = q.reshape(b * h, lq, dh).contiguous()
    kf = k.reshape(b * hkv, lk, dh).contiguous()
    vf = v.reshape(b * hkv, lk, dh).contiguous()
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
    _no_grad("online_wht_2d", x)
    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    return _wht.wht(x.reshape(-1, d), **kw).reshape(lead + (d,))


# ---------------------------------------------------------------------------
# unified-datapath wrappers (kernels/fused.py)
# ---------------------------------------------------------------------------


def _wht_block(on: bool, width: int):
    return transforms.block_size_for(width) if on else None


def fused_linear(x, p, *, tiles=None):
    """One-launch QuantLinear apply: prologue (norm → WHT → quantize) +
    integer matmul + epilogue (IDCT → bias → act → WHT → requant), driven
    by the layer's ``prologue``/``epilogue`` descriptors
    (``core.versaq.QuantLinear``).

    ``x``: float [..., K], or a pre-quantized ``QTensor`` (e.g. from
    :func:`norm_quant_prologue`, shared across several projections).
    Returns float32 [..., N], or a per-token-scaled ``QTensor`` when the
    epilogue requantizes.  ``tiles`` (default: the site's own
    ``p.tiles``): see :func:`launch_tiles`.
    """
    _no_grad("fused_linear", x, p.qw, p.bias, p.norm_u)
    launch_tiles("fused_matmul", getattr(p, "tiles", None) if tiles is None else tiles)
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


def fused_ffn_apply(x: torch.Tensor, f, *, tiles=None) -> torch.Tensor:
    """The whole gated/plain FFN layer in ONE launch
    (``core.versaq.FusedFFN``): norm prologue → shared A-quant → gate/up
    int matmuls → act·gate → hidden WHT → requant → down int matmul →
    IDCT/biases.  x: float [..., D] -> float32 [..., d_out].  ``tiles``
    (default: the member sites' ``tiles``, which a schedule sets to its
    FFN group's): see :func:`launch_tiles`."""
    members = (f.w_up, f.w_down) + (() if f.w_gate is None else (f.w_gate,))
    _no_grad("fused_ffn_apply", x, f.norm_u, *[t for m in members for t in (m.qw, m.bias)])
    for t in [tiles] if tiles is not None else [getattr(m, "tiles", None) for m in members]:
        launch_tiles("fused_ffn", t)
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
    _no_grad("norm_quant_prologue", x, norm_u)
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
