"""GQA attention in ``mode="full"`` (port of ``repro/models/attention.py``
in the part VGGT needs; the prefill/decode cache paths and MLA wait for
the LM slice).

Per the paper's Stage-2 flow: Q/K get an online per-head WHT when the
layer is quantized (scores invariant, distributions smoothed); V carries
an offline per-head Hadamard folded into W_v/W_o.

A fused tree (``PrecisionPlan(fuse=True)``) carries one ``wqkv`` site
whose kernel launch absorbs the pre-norm and quantizes the input once for
all three projections.

Routing follows the reference exactly:

* quantized layers with ``attn_impl="two_stage"`` (and
  ``attn_use_kernel``) run the INT8 two-stage CUDA kernel — but only when
  ``kv_mask is None`` (padded serving buckets take the emulation, which
  supports masks) and only when ``min(Lq, Lk) >= 8``;
* everything else runs :func:`sdpa_dispatch`: the vanilla
  :func:`_sdpa`, or :func:`_sdpa_streamed` (flash or two-stage float
  emulations over 1024-key chunks).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.versaq import QuantLinear, head_wht
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L

__all__ = ["init_gqa", "gqa_attention", "sdpa_dispatch", "CHUNK"]

NEG_INF = -1e30
CHUNK = 1024


def init_gqa(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None) -> dict:
    dh = cfg.head_dim
    kw = dict(bias=cfg.attn_bias, dtype=dtype, device=device)
    return {
        "wq": L.init_linear(generator, cfg.d_model, cfg.n_heads * dh, **kw),
        "wk": L.init_linear(generator, cfg.d_model, cfg.n_kv_heads * dh, **kw),
        "wv": L.init_linear(generator, cfg.d_model, cfg.n_kv_heads * dh, **kw),
        "wo": L.init_linear(generator, cfg.n_heads * dh, cfg.d_model, **kw),
    }


def _sqrt_f32(n: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=device))


def _sdpa(q, k, v, *, causal: bool, kv_mask: Optional[torch.Tensor] = None):
    """Vanilla SDPA (materializes [Lq, Lk] scores) — ablation baseline.

    q: [B,Lq,H,dh]; k/v: [B,Lk,Hkv,dh].  f32 softmax, GQA broadcast.
    ``kv_mask``: [B, Lk] bool — False keys are excluded."""
    b, lq, h, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.reshape(b, lq, hkv, g, dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32)) / _sqrt_f32(dh, q.device)
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        keep = torch.arange(lq, device=q.device)[:, None] >= torch.arange(lk, device=q.device)[None, :]
        s = torch.where(keep, s, neg)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, lq, h, v.shape[-1])


def _sdpa_streamed(q, k, v, *, causal: bool, two_stage: bool = False,
                   compute_dtype: str = "f32", kv_mask: Optional[torch.Tensor] = None):
    """Streaming attention over KV chunks — never materializes [Lq, Lk].

    ``two_stage=False``: FlashAttention-style single pass carrying
    (m, l, o) with O rescaling.  ``two_stage=True``: the paper's Alg. 1 in
    float — pass ① computes only (m, l), pass ② recomputes Q·Kᵀ with the
    final statistics over 2x larger chunks and accumulates O with no
    rescaling.  Operands round to ``compute_dtype`` and the products sum in
    float32 (the reference's ``preferred_element_type``).
    """
    b, lq, h, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    cdt = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    qf = (q.reshape(b, lq, hkv, g, dh) / _sqrt_f32(dh, q.device).to(q.dtype)).to(cdt).float()
    kf = k.to(cdt).float()
    vf = v.to(cdt).float()
    chunk = CHUNK
    n_chunks = max(1, (lk + chunk - 1) // chunk)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    def scores(c0, c1):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, c0:c1])
        if causal:
            rows = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
            cols = c0 + torch.arange(c1 - c0, device=q.device)[None, :]
            s = torch.where(rows >= cols, s, neg)
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, None, c0:c1], s, neg)
        return s

    def live(c0):  # causal: skip chunks fully above the diagonal
        return (not causal) or (c0 <= (lk - lq) + lq - 1)

    m = torch.full((b, hkv, g, lq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, lq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, g, lq, dv), dtype=torch.float32, device=q.device)
    if two_stage:
        for c in range(n_chunks):  # pass ① — statistics only (Eq. 8-9)
            c0, c1 = c * chunk, min((c + 1) * chunk, lk)
            if not live(c0):
                continue
            s = scores(c0, c1)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(dim=-1, keepdim=True)
            m = m_new
        big = chunk * 2  # Stage-② mega-tiles (T_V > T_K)
        for c in range(max(1, (lk + big - 1) // big)):  # pass ② — no rescale
            c0, c1 = c * big, min((c + 1) * big, lk)
            if not live(c0):
                continue
            p = torch.exp(scores(c0, c1) - m)
            o = o + torch.einsum("bhgqk,bkhd->bhgqd", p.to(cdt).float(), vf[:, c0:c1])
    else:
        for c in range(n_chunks):
            c0, c1 = c * chunk, min((c + 1) * chunk, lk)
            if not live(c0):
                continue
            s = scores(c0, c1)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p.to(cdt).float(), vf[:, c0:c1])
            m = m_new
    o = o / torch.clamp_min(l, 1e-30)
    return o.reshape(b, hkv * g, lq, dv).movedim(1, 2)


def sdpa_dispatch(cfg, q, k, v, *, causal: bool, kv_mask=None):
    impl = getattr(cfg, "attn_impl", "flash")
    if impl == "vanilla":
        return _sdpa(q, k, v, causal=causal, kv_mask=kv_mask)
    return _sdpa_streamed(q, k, v, causal=causal, two_stage=(impl == "two_stage"),
                          compute_dtype=getattr(cfg, "attn_dtype", "f32"), kv_mask=kv_mask)


def _two_stage_kernel_sdpa(q, k, v, *, causal: bool):
    """Quantized fast path: the INT8 two-stage CUDA kernel (paper Alg. 1).

    q: [B,Lq,H,dh]; k/v: [B,Lk,Hkv,dh] float, already per-head rotated.
    Returns None for sequences under 8 tokens, which take the emulation
    as in the reference."""
    lq, lk = q.shape[1], k.shape[1]
    if min(lq, lk) < 8:
        return None
    o = kernel_ops.two_stage_mha(
        q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1), causal=causal
    )
    return o.movedim(1, 2)


def gqa_attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    mode: str = "full",
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over the whole sequence of x [B, L, d]; ``kv_mask`` [B, L]
    bool excludes padded keys.  Returns [B, L, d]."""
    if mode != "full":
        raise NotImplementedError(f"attention mode {mode!r} not ported yet (only 'full')")
    if cfg.qk_norm or cfg.pos == "rope":
        raise NotImplementedError("qk-norm and RoPE are not ported yet (VGGT uses neither)")
    b, lq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "wqkv" in p:
        # unified datapath: one launch runs the absorbed pre-norm (the
        # caller passed the raw stream — see ``core.versaq.carries_norm``),
        # the shared per-token quantization and all three projections
        quantized = isinstance(p["wqkv"], QuantLinear)
        q, k, v = torch.split(L.dense(p["wqkv"], x), [h * dh, hkv * dh, hkv * dh], dim=-1)
        q = q.reshape(b, lq, h, dh)
        k = k.reshape(b, lq, hkv, dh)
        v = v.reshape(b, lq, hkv, dh)
    else:
        quantized = isinstance(p["wq"], QuantLinear)
        q = L.dense(p["wq"], x).reshape(b, lq, h, dh)
        k = L.dense(p["wk"], x).reshape(b, lq, hkv, dh)
        v = L.dense(p["wv"], x).reshape(b, lq, hkv, dh)
    if quantized:
        # paper Stage 2: online per-head WHT on Q/K (scores invariant);
        # V arrives per-head-rotated from the offline W_v fusion
        q = head_wht(q)
        k = head_wht(k)
    o = None
    if (
        quantized
        and getattr(cfg, "attn_impl", "flash") == "two_stage"
        and getattr(cfg, "attn_use_kernel", True)
        and kv_mask is None
    ):
        o = _two_stage_kernel_sdpa(q, k, v, causal=causal)
    if o is None:
        o = sdpa_dispatch(cfg, q, k, v, causal=causal, kv_mask=kv_mask)
    o = o.reshape(b, lq, h * dh).to(x.dtype)
    return L.dense(p["wo"], o)
