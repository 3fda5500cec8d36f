"""Attention mixers: GQA (with qk-norm and RoPE) and MLA (DeepSeek-V2's
multi-head latent attention), with their int8 KV caches (port of
``repro/models/attention.py``).

Three entry modes:

* ``full``    — attention over the whole sequence (causal flag per call;
  VGGT's frame/global attention is bidirectional, LM scoring causal);
* ``prefill`` — like full, and also writes the int8-quantized KV cache;
* ``decode``  — new tokens against the cache.

Per the paper's Stage-2 flow: Q/K get an online per-head WHT after
RoPE/qk-norm when the layer is quantized (scores invariant, distributions
smoothed); V carries an offline per-head Hadamard folded into W_v/W_o.

MLA caches the compressed ``[c_kv, k_rope]`` (``kv_lora_rank +
qk_rope_dim`` int8 a token and layer, one scale) in the cache's ``k`` slot;
its full and prefill modes up-project K/V from the fresh ``c_kv`` and
attend in float, and its decode is absorbed: the query moves into the
compressed domain (``q_nope · W_k_upᵀ``), attends over the dequantized
cache, and the result goes back through ``W_v_up``.

A fused tree (``PrecisionPlan(fuse=True)``) carries one ``wqkv`` site
whose kernel launch absorbs the pre-norm and quantizes the input once for
all three projections.

Routing follows the reference exactly:

* ``mode="full"`` on quantized layers with ``attn_impl="two_stage"`` (and
  ``attn_use_kernel``) runs the INT8 two-stage CUDA kernel — but only when
  no key mask applies (padded serving buckets take the emulation, which
  supports masks) and only when ``min(Lq, Lk) >= 8``;
* everything else runs :func:`sdpa_dispatch`: the vanilla :func:`_sdpa`
  (also every cache-masked call), or :func:`_sdpa_streamed` (flash or
  two-stage float emulations over 1024-key chunks).  The served prefill
  and decode paths are of this kind, as in the reference.

The KV cache differs from the reference in two ways, neither numeric.
Its ``length`` (the write position) is a host ``int``: every row of a
served batch shares one decode clock, so positions, masks and cache writes
need no device-to-host read per step.  And the cache is written in place
(the reference's jitted steps donate the cache buffers, to the same
effect): the returned ``KVCache`` holds the same tensors with the new
length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import transforms
from repro_torch.core.quantize import quantize_per_token
from repro_torch.core.versaq import QuantLinear, head_wht
from repro_torch.models import layers as L
from repro_torch.sharded import kernels_for, routed

__all__ = [
    "KVCache",
    "init_kv_cache",
    "roll_kv",
    "init_gqa",
    "gqa_attention",
    "init_mla",
    "mla_attention",
    "absorbed_attend",
    "sdpa_dispatch",
    "CHUNK",
]

NEG_INF = -1e30
CHUNK = 1024


class KVCache(NamedTuple):
    """int8 KV cache with per-(token, head) scales.

    k/v: [B, S, Hkv, dh] int8 (stacked scan groups: [G, B, S, Hkv, dh]);
    k_scale/v_scale: the same with a trailing 1, float32.  ``length``: the
    current fill, a host ``int`` shared by every row and, for a stacked
    cache, every group (see the module docstring).  For MLA the ``k`` slot
    holds the compressed ``[c_kv, k_rope]`` as [B, S, 1, rank + dr] and
    ``v``/``v_scale`` are unused [..., 1, 1] placeholders."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: int


def _pad_mask(pad_lens: torch.Tensor, width: int) -> torch.Tensor:
    """Key-slot validity for LEFT-padded rows: slot s of a row with
    ``pad_lens[b]`` leading pad positions is valid iff ``s >= pad_lens[b]``
    (serving pads prompts on the left so the last real token always sits
    in the last prompt slot).  Shape [B, width] bool."""
    return torch.arange(width, device=pad_lens.device)[None, :] >= pad_lens[:, None]


def roll_kv(cache: KVCache, shift: int) -> KVCache:
    """Shift every cached token right by ``shift`` slots along the time
    axis (the slot scheduler's re-alignment: a prompt prefilled at bucket
    width L joins a decode batch at clock T by rolling its rows so the last
    real token lands at slot T-1).  Wrapped-around garbage lands in the
    region ``pad_lens`` masks off.  Works on both layouts — [B, S, Hkv, d]
    and stacked [G, B, S, Hkv, d] — because the time axis is always third
    from the end.  ``length`` is left untouched."""
    axis = cache.k.ndim - 3
    return cache._replace(
        k=torch.roll(cache.k, shift, dims=axis),
        v=torch.roll(cache.v, shift, dims=axis),
        k_scale=torch.roll(cache.k_scale, shift, dims=axis),
        v_scale=torch.roll(cache.v_scale, shift, dims=axis),
    )


@routed
def write_slots(buf: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """Write ``new`` [B, L, ...] into slots ``[start, start + L)`` of the
    cache buffer ``buf`` [B, S, ...], in place."""
    buf[:, start:start + new.shape[1]] = new


def _quant_tokens_like(x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize per (token, head) for an int8 cache (the reference's
    ``_quant_tokens`` is ``quantize_per_token`` at 8 bits); pass through
    for a bf16 cache (the unquantized baseline)."""
    if dtype == torch.int8:
        q = quantize_per_token(x, 8)
        return q.values, q.scale
    return x.to(dtype), torch.ones(tuple(x.shape[:-1]) + (1,), dtype=torch.float32,
                                   device=x.device)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_groups: int,
                  kv_dtype=torch.int8, device=None) -> KVCache:
    """Stacked cache for ``n_groups`` scan groups: the GQA layout, or MLA's
    compressed one (one ``rank + dr`` row a token, see :class:`KVCache`)."""
    if cfg.mla:
        shape = (n_groups, batch, max_len, 1)
        kd, vd = cfg.kv_lora_rank + cfg.qk_rope_dim, 1
    else:
        shape = (n_groups, batch, max_len, cfg.n_kv_heads)
        kd = vd = cfg.head_dim
    return KVCache(
        k=torch.zeros(shape + (kd,), dtype=kv_dtype, device=device),
        v=torch.zeros(shape + (vd,), dtype=kv_dtype, device=device),
        k_scale=torch.zeros(shape + (1,), dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape + (1,), dtype=torch.float32, device=device),
        length=0,
    )


def init_gqa(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32, device=None) -> dict:
    dh = cfg.head_dim
    kw = dict(bias=cfg.attn_bias, dtype=dtype, device=device)
    p = {
        "wq": L.init_linear(generator, cfg.d_model, cfg.n_heads * dh, **kw),
        "wk": L.init_linear(generator, cfg.d_model, cfg.n_kv_heads * dh, **kw),
        "wv": L.init_linear(generator, cfg.d_model, cfg.n_kv_heads * dh, **kw),
        "wo": L.init_linear(generator, cfg.n_heads * dh, cfg.d_model, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_norm(dh, kind="rms", dtype=dtype, device=device)
        p["k_norm"] = L.init_norm(dh, kind="rms", dtype=dtype, device=device)
    return p


def _sqrt_f32(n: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=device))


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0, kv_len: Optional[int] = None,
          kv_mask: Optional[torch.Tensor] = None, k_offset: int = 0, stats: bool = False):
    """Vanilla SDPA (materializes [Lq, Lk] scores) — ablation baseline and
    the cache-masked path.

    q: [B,Lq,H,dh]; k/v: [B,Lk,Hkv,dh].  f32 softmax, GQA broadcast.
    ``q_offset``: position of the first query (decode); ``kv_len``: keys at
    or past it are unwritten cache slots; ``kv_mask``: [B, Lk] bool — False
    keys are excluded.  ``k_offset``: the position of the first key (one
    rank's shard of a sequence-sharded cache); with ``stats`` the call also
    returns each row's score max and sum of exponentials ([B, Lq, H, 1]),
    which ``parallel.sites`` combines across the shards."""
    b, lq, h, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.reshape(b, lq, hkv, g, dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32)) / _sqrt_f32(dh, q.device)
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    cols = k_offset + torch.arange(lk, device=q.device)[None, :]
    if causal:
        rows = q_offset + torch.arange(lq, device=q.device)[:, None]
        s = torch.where(rows >= cols, s, neg)
    if kv_len is not None:  # mask unwritten cache slots
        s = torch.where(cols < kv_len, s, neg)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    o = o.reshape(b, lq, h, v.shape[-1])
    if not stats:
        return o
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    return o, *(t.movedim(3, 1).reshape(b, lq, h, 1) for t in (m, l))


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


@routed
def sdpa_dispatch(cfg, q, k, v, *, causal: bool, q_offset: int = 0, kv_len=None, kv_mask=None,
                  k_offset: int = 0, stats: bool = False):
    """The float attention of q [B, Lq, H, dh] over k/v [B, Lk, Hkv, dh]:
    the vanilla :func:`_sdpa` under ``attn_impl="vanilla"`` and on every
    cache-masked call (``kv_len``), else :func:`_sdpa_streamed`.
    ``k_offset``/``stats`` (cache-masked calls only) are the sharded
    route's: see :func:`_sdpa`."""
    impl = getattr(cfg, "attn_impl", "flash")
    if impl == "vanilla" or kv_len is not None:
        # cache-masked paths take the masked vanilla form (decode scores
        # are [*, 1, S]: linear, not quadratic)
        return _sdpa(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, kv_mask=kv_mask,
                     k_offset=k_offset, stats=stats)
    return _sdpa_streamed(q, k, v, causal=causal, two_stage=(impl == "two_stage"),
                          compute_dtype=getattr(cfg, "attn_dtype", "f32"), kv_mask=kv_mask)


def _two_stage_kernel_sdpa(q, k, v, *, causal: bool, tiles: tuple | None = None):
    """Quantized fast path: the INT8 two-stage CUDA kernel (paper Alg. 1).

    q: [B,Lq,H,dh]; k/v: [B,Lk,Hkv,dh] float, already per-head rotated.
    ``tiles``: a compiled schedule's launch tiles (``cfg.attn_tiles``),
    checked by ``kernels.ops.two_stage_mha``.  Returns None for sequences
    under 8 tokens, which take the emulation as in the reference."""
    lq, lk = q.shape[1], k.shape[1]
    if min(lq, lk) < 8:
        return None
    o = kernels_for(q).two_stage_mha(
        q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1), causal=causal, tiles=tiles
    )
    return o.movedim(1, 2)


def gqa_attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    mode: str = "full",
    kv_mask: Optional[torch.Tensor] = None,
    pad_lens: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention of x [B, L, d] -> ([B, L, d], new cache or None).

    ``positions`` [B|1, L]: RoPE positions (default ``arange(L)``);
    ``kv_mask`` [B, L] bool excludes padded keys in full mode (VGGT);
    ``pad_lens`` [B]: left-pad counts of a serving bucket, whose key mask
    applies in every mode.  ``cache`` with ``mode`` ``prefill``/``decode``
    writes this call's K/V at ``cache.length`` (in place, see the module
    docstring) and attends over the cache."""
    b, lq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "wqkv" in p:
        # unified datapath: one launch runs the absorbed pre-norm (the
        # caller passed the raw stream — see ``core.versaq.carries_norm``),
        # the shared per-token quantization and all three projections
        quantized = isinstance(p["wqkv"], QuantLinear)
        q, k, v = torch.split(L.dense(p["wqkv"], x), [h * dh, hkv * dh, hkv * dh], dim=-1)
        q = L.split_dim(q, -1, (h, dh))
        k = L.split_dim(k, -1, (hkv, dh))
        v = L.split_dim(v, -1, (hkv, dh))
    else:
        quantized = isinstance(p["wq"], QuantLinear)
        q = L.split_dim(L.dense(p["wq"], x), -1, (h, dh))
        k = L.split_dim(L.dense(p["wk"], x), -1, (hkv, dh))
        v = L.split_dim(L.dense(p["wv"], x), -1, (hkv, dh))
    if cfg.qk_norm:
        q = L.norm(p["q_norm"], q)
        k = L.norm(p["k_norm"], k)
    if cfg.pos == "rope":
        if positions is None:
            positions = torch.arange(lq, device=x.device)[None, :]
        cos, sin = L.rope_freqs(dh, cfg.rope_theta, positions)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    if quantized:
        # paper Stage 2: post-RoPE online per-head WHT on Q/K (scores
        # invariant); V arrives per-head-rotated from the offline W_v fusion
        q = head_wht(q)
        k = head_wht(k)
    if pad_lens is not None and kv_mask is not None:
        raise ValueError("pass either kv_mask or pad_lens, not both")

    if mode == "full" or cache is None:
        if pad_lens is not None:
            kv_mask = _pad_mask(pad_lens, lq)
        o = None
        if (
            quantized
            and getattr(cfg, "attn_impl", "flash") == "two_stage"
            and getattr(cfg, "attn_use_kernel", True)
            and kv_mask is None
        ):
            o = _two_stage_kernel_sdpa(q, k, v, causal=causal,
                                       tiles=getattr(cfg, "attn_tiles", None))
        if o is None:
            o = sdpa_dispatch(cfg, q, k, v, causal=causal, kv_mask=kv_mask)
        new_cache = None
    else:
        if kv_mask is not None:
            raise ValueError("kv_mask is not supported on the prefill/decode cache paths")
        pos0 = int(cache.length)
        new_len = pos0 + lq
        if new_len > cache.k.shape[1]:
            raise ValueError(f"KV cache overflow: writing slots {pos0}..{new_len - 1} of "
                             f"{cache.k.shape[1]}")
        kq, ks_ = _quant_tokens_like(k, cache.k.dtype)
        vq, vs_ = _quant_tokens_like(v, cache.v.dtype)
        for buf, new in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks_),
                         (cache.v_scale, vs_)):
            write_slots(buf, pos0, new)
        new_cache = cache._replace(length=new_len)
        if mode == "prefill" and lq > 1:
            # attention over the freshly quantized K/V (prefill starts the
            # cache: earlier slots are empty)
            kf = kq.to(torch.float32) * ks_
            vf = vq.to(torch.float32) * vs_
            mask = _pad_mask(pad_lens, lq) if pad_lens is not None else None
            o = sdpa_dispatch(cfg, q, kf, vf, causal=causal, kv_mask=mask)
        else:
            # decode: [*, 1, S] scores over the whole cache, masked vanilla
            # path; left-pad slots written by a bucketed prefill are masked
            kf = cache.k.to(torch.float32) * cache.k_scale
            vf = cache.v.to(torch.float32) * cache.v_scale
            mask = _pad_mask(pad_lens, cache.k.shape[1]) if pad_lens is not None else None
            o = sdpa_dispatch(cfg, q, kf, vf, causal=causal, q_offset=pos0, kv_len=new_len,
                              kv_mask=mask)
    o = o.reshape(b, lq, h * dh).to(x.dtype)
    return L.dense(p["wo"], o), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV cache, absorbed decode
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    h, rank = cfg.n_heads, cfg.kv_lora_rank
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": L.init_linear(generator, cfg.d_model, h * (cfg.qk_nope_dim + cfg.qk_rope_dim), **kw),
        "w_kv_down": L.init_linear(generator, cfg.d_model, rank + cfg.qk_rope_dim, **kw),
        "kv_norm": L.init_norm(rank, kind="rms", **kw),
        "w_k_up": L.init_linear(generator, rank, h * cfg.qk_nope_dim, **kw),
        "w_v_up": L.init_linear(generator, rank, h * cfg.v_head_dim, **kw),
        "wo": L.init_linear(generator, h * cfg.v_head_dim, cfg.d_model, **kw),
    }


def _absorbed_weight(p) -> torch.Tensor:
    """An up-projection's [rank, H·d] weight in float32 for absorption: a
    full-precision site's ``w``, or a ``QuantLinear`` dequantized (its W4
    nibbles unpacked) with its output-side block IDCT applied, as the
    reference does."""
    if isinstance(p, dict):
        return p["w"].to(torch.float32)
    w = p.qw.dequantize(torch.float32)
    if p.idct:
        w = transforms.apply_blocked(w, transforms.dct_matrix(p.dct_block, device=w.device),
                                     p.dct_block)
    return w


def _write_compressed(cache: KVCache, ck: torch.Tensor, pos0: int) -> tuple[KVCache, int]:
    """Quantize [c_kv, k_rope] ([B, L, 1, rank + dr]) per token and write it
    at ``pos0``, in place; returns the cache at its new length."""
    new_len = pos0 + ck.shape[1]
    if new_len > cache.k.shape[1]:
        raise ValueError(f"KV cache overflow: writing slots {pos0}..{new_len - 1} of "
                         f"{cache.k.shape[1]}")
    ckq, cks = _quant_tokens_like(ck, cache.k.dtype)
    write_slots(cache.k, pos0, ckq)
    write_slots(cache.k_scale, pos0, cks)
    return cache._replace(length=new_len), new_len


@routed
def absorbed_attend(q_lora, q_rope, ck, *, rank: int, scale: torch.Tensor, q_offset: int,
                    kv_len: int, kv_mask: Optional[torch.Tensor] = None, k_offset: int = 0,
                    stats: bool = False):
    """MLA's absorbed decode attention: queries in the compressed domain,
    q_lora [B, Lq, H, rank] and q_rope [B, Lq, H, dr], over the dequantized
    compressed cache ck [B, S, rank + dr]; returns the attention-weighted
    c_kv, [B, Lq, H, rank].  Scores are ``(q_lora·c + q_rope·k_rope) ·
    scale``, causal from ``q_offset``, keys at or past ``kv_len`` and where
    ``kv_mask`` [B, S] is False masked.  ``k_offset``/``stats`` are the
    sharded route's (``parallel.sites.absorbed_attend``, which splits the
    keys over the ranks and combines their partial softmaxes): the first
    key's position, and the rows' score max and sum of exponentials
    ([B, Lq, H, 1]) returned beside the output."""
    c_all, krope_all = ck[..., :rank], ck[..., rank:]
    s = (torch.einsum("bqhr,bkr->bhqk", q_lora, c_all)
         + torch.einsum("bqhd,bkd->bhqk", q_rope, krope_all)) * scale
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    rows = q_offset + torch.arange(q_lora.shape[1], device=s.device)[:, None]
    cols = k_offset + torch.arange(c_all.shape[1], device=s.device)[None, :]
    s = torch.where((rows >= cols) & (cols < kv_len), s, neg)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, neg)
    att = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkr->bqhr", att, c_all)
    if not stats:
        return o
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    return o, m.transpose(1, 2), l.transpose(1, 2)


def mla_attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    mode: str = "full",
    pad_lens: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """MLA of x [B, L, d] -> ([B, L, d], new cache or None).

    ``mode="full"``, a call without a cache, and a prefill of more than one
    token materialize per-head K/V from the fresh ``c_kv`` and run
    :func:`sdpa_dispatch` (q/k head dim ``dn + dr``, v head dim ``dv``; the
    two-stage kernel is never reached, as in the reference); a prefill also
    writes the quantized ``[c_kv, k_rope]`` at ``cache.length``.  Decode
    (and a one-token prefill) is absorbed: the new token is written, the
    whole compressed cache is dequantized, and the scores are
    ``q_nope·W_k_upᵀ·c + q_rope·k_rope`` over it (:func:`absorbed_attend`;
    on a sharded path the ranks split the cache's slots and combine their
    partial softmaxes).  ``pad_lens`` masks left-pad slots in both
    branches."""
    b, lq, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, rank = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    if positions is None:
        positions = torch.arange(lq, device=x.device)[None, :]

    q = L.dense(p["wq"], x).reshape(b, lq, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = L.dense(p["w_kv_down"], x)
    c_kv, k_rope = kv[..., :rank], kv[..., rank:]
    c_kv = L.norm(p["kv_norm"], c_kv)
    cos, sin = L.rope_freqs(dr, cfg.rope_theta, positions)
    q_rope = L.apply_rope(q_rope, cos, sin)
    k_rope = L.apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]  # shared across heads

    if mode == "full" or cache is None or (mode == "prefill" and lq > 1):
        # materialize per-token K/V from the fresh c_kv and attend in float
        k_nope = L.dense(p["w_k_up"], c_kv).reshape(b, lq, h, dn)
        v = L.dense(p["w_v_up"], c_kv).reshape(b, lq, h, dv)
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, lq, h, dr)], dim=-1)
        mask = _pad_mask(pad_lens, lq) if pad_lens is not None else None
        o = sdpa_dispatch(cfg, q_eff, k_eff, v, causal=causal, kv_mask=mask)
        new_cache = None
        if mode == "prefill" and cache is not None:
            ck = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
            new_cache, _ = _write_compressed(cache, ck, int(cache.length))
    else:
        # absorbed decode: score in the compressed domain over the cache
        pos0 = int(cache.length)
        ck = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]  # [B, L, 1, rank + dr]
        new_cache, new_len = _write_compressed(cache, ck, pos0)
        ckf = (cache.k.to(torch.float32) * cache.k_scale)[:, :, 0, :]  # [B, S, rank + dr]
        wku = _absorbed_weight(p["w_k_up"]).reshape(rank, h, dn)
        q_lora = torch.einsum("bqhd,rhd->bqhr", q_nope.to(torch.float32), wku)
        # left-pad slots from a bucketed prefill are masked
        mask = _pad_mask(pad_lens, ckf.shape[1]) if pad_lens is not None else None
        o_lora = absorbed_attend(q_lora, q_rope.to(torch.float32), ckf, rank=rank,
                                 scale=1.0 / _sqrt_f32(dn + dr, x.device), q_offset=pos0,
                                 kv_len=new_len, kv_mask=mask)
        wvu = _absorbed_weight(p["w_v_up"]).reshape(rank, h, dv)
        o = torch.einsum("bqhr,rhd->bqhd", o_lora, wvu)
    o = o.reshape(b, lq, h * dv).to(x.dtype)
    return L.dense(p["wo"], o), new_cache
