"""Config-driven LM composition: init / forward / prefill / decode (port of
``repro/models/lm.py``: dense GQA stacks, MoE stacks, MLA stacks, RWKV-6
stacks and Mamba/attention hybrids).

The reference groups the layer stack by the config's ``pattern`` period
and scans the groups with ``jax.lax.scan``; here the scan is a Python loop
over the stacked group axis, and the parameter tree keeps the reference's
layout: ``params["blocks"]["l{j}"]`` with a leading group axis, and the
non-uniform first layers as the list ``params["prefix"]``.

The same forward runs full precision (plain dict leaves) and
VersaQ-quantized (``QuantLinear``/``FoldedNorm`` leaves, see
``core/model_quant.py::quantize_lm``).  With ``pad_lens`` the forward also
masks the pad slots out of MoE routing (``token_mask``), as the reference
does.

The decode cache's ``pos`` and every ``KVCache.length`` are host ints: all
rows of a served batch share one decode clock (see ``models/attention.py``).
An rwkv pattern position holds an ``RWKVState`` instead, a Mamba one a
``MambaState``; like the KV cache they are written in place, and they have no
time axis.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.obs import trace
from repro_torch.tree import tree_index, tree_stack

__all__ = [
    "n_scan_groups",
    "ffn_kind",
    "mixer_kind",
    "init_params",
    "init_cache",
    "cache_resize",
    "cache_install_rows",
    "cache_set_clock",
    "forward",
    "decode_step",
]

# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------


def n_scan_groups(cfg: ModelConfig) -> int:
    return (cfg.n_layers - cfg.first_dense) // len(cfg.pattern)


def ffn_kind(cfg: ModelConfig, global_idx: int) -> str:
    if cfg.pattern[global_idx % len(cfg.pattern)] == "rwkv":
        return "rwkv_channel"
    if not cfg.moe:
        return "dense"
    if global_idx < cfg.first_dense:
        return "dense"
    return "moe" if (global_idx % cfg.moe_period) == 0 else "dense_inner"


def mixer_kind(cfg: ModelConfig, global_idx: int) -> str:
    return cfg.pattern[global_idx % len(cfg.pattern)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator: torch.Generator, cfg: ModelConfig, global_idx: int, dtype,
                device) -> dict:
    kw = dict(dtype=dtype, device=device)
    kind = mixer_kind(cfg, global_idx)
    if kind == "rwkv":
        p: dict[str, Any] = {
            "mixer_norm": L.init_norm(cfg.d_model, kind="ln", bias=True, **kw),
            "mixer": R.init_rwkv_time(generator, cfg, **kw),
            "ffn_norm": L.init_norm(cfg.d_model, kind="ln", bias=True, **kw),
            "ffn": R.init_rwkv_channel(generator, cfg, **kw),
        }
    else:
        if ffn_kind(cfg, global_idx) == "moe":
            ffn = F.init_moe(generator, cfg, **kw)
        else:
            # a MoE stack's dense layers (the first_dense prefix and the
            # dense_inner ones) take dense_d_ff, as in the reference
            dff = (cfg.dense_d_ff or cfg.d_ff) if cfg.moe else cfg.d_ff
            ffn = F.init_dense_ffn(generator, cfg.d_model, dff, cfg.act, **kw)
        if kind == "mamba":
            mixer = S.init_mamba(generator, cfg, **kw)
        else:
            mixer = (A.init_mla if cfg.mla else A.init_gqa)(generator, cfg, **kw)
        p = {
            "mixer_norm": L.init_norm(cfg.d_model, kind=cfg.norm, bias=cfg.norm_bias, **kw),
            "mixer": mixer,
            "ffn_norm": L.init_norm(cfg.d_model, kind=cfg.norm, bias=cfg.norm_bias, **kw),
            "ffn": ffn,
        }
    if cfg.layerscale:
        p["ls1"] = torch.full((cfg.d_model,), cfg.layerscale_init, **kw)
        p["ls2"] = torch.full((cfg.d_model,), cfg.layerscale_init, **kw)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    """Random weights drawn from ``generator``, on ``device`` (default: the
    generator's).  On the ``meta`` device nothing is drawn: the tree
    carries shapes and dtypes only."""
    dev = generator.device if device is None else torch.device(device)
    params: dict[str, Any] = {
        "embed": {"w": (torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                                    device=dev) * 0.02).to(dtype)},
    }
    if cfg.embed_inputs:
        params["in_proj"] = L.init_linear(generator, cfg.d_model, cfg.d_model, dtype=dtype,
                                          device=dev)
    params["prefix"] = [_init_layer(generator, cfg, i, dtype, dev) for i in range(cfg.first_dense)]
    period = len(cfg.pattern)
    groups = [{f"l{j}": _init_layer(generator, cfg, cfg.first_dense + g * period + j, dtype, dev)
               for j in range(period)}
              for g in range(n_scan_groups(cfg))]
    params["blocks"] = tree_stack(groups)
    params["final_norm"] = L.init_norm(cfg.d_model, kind=cfg.norm, bias=cfg.norm_bias,
                                       dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(generator, cfg.d_model, cfg.vocab_size, dtype=dtype,
                                          device=dev, scale=0.02)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype=torch.int8,
               device=None) -> dict:
    """Decode cache matching the prefix/blocks structure: per pattern
    position a stacked ``KVCache`` [G, B, max_len, Hkv, dh] (attention; MLA's
    compressed [G, B, max_len, 1, rank + dr]), ``RWKVState`` [G, B, ...]
    (rwkv) or ``MambaState`` [G, B, ...] (mamba); per prefix layer an
    unstacked [B, max_len, Hkv, dh] cache (None for a recurrent one, as in
    the reference); and ``pos`` 0."""
    groups = n_scan_groups(cfg)
    blocks: dict[str, Any] = {}
    for j, kind in enumerate(cfg.pattern):
        if kind == "attn":
            blocks[f"l{j}"] = A.init_kv_cache(cfg, batch, max_len, groups, kv_dtype, device)
        elif kind == "mamba":
            blocks[f"l{j}"] = S.init_mamba_state(cfg, batch, groups, device)
        else:
            blocks[f"l{j}"] = R.init_rwkv_state(cfg, batch, groups, device)
    prefix = []
    for i in range(cfg.first_dense):
        if mixer_kind(cfg, i) == "attn":
            c = A.init_kv_cache(cfg, batch, max_len, 1, kv_dtype, device)
            prefix.append(A.KVCache(c.k[0], c.v[0], c.k_scale[0], c.v_scale[0], c.length))
        else:
            prefix.append(None)
    return {"prefix": prefix, "blocks": blocks, "pos": 0}


# ---------------------------------------------------------------------------
# slot-cache surgery (the continuous-batching scheduler's primitives)
#
# The decode cache doubles as a *slot* cache: each batch row is a slot a
# request occupies from admission to completion.  A scheduler grows and
# shrinks the slot axis (cache_resize), installs freshly prefilled rows into
# free slots (cache_install_rows), and keeps every layer's write position on
# the shared decode clock (cache_set_clock).  All three are pure index
# surgery.  cache_resize returns new tensors; cache_install_rows writes into
# its destination, as the forward writes the cache (the scheduler owns its
# cache, so a copy of it per admission would buy nothing); cache_set_clock
# changes host ints only.  Recurrent states have no time axis: they resize
# and install on their batch axis 1 and never roll.
# ---------------------------------------------------------------------------


def _kv_batch_axis(c: A.KVCache) -> int:
    # prefix caches are [B, S, H, d] (axis 0); stacked block caches carry a
    # leading scan-group axis [G, B, S, H, d] (axis 1)
    return c.k.ndim - 4


_KV_FIELDS = ("k", "v", "k_scale", "v_scale")


def _cache_map(cache: dict, on_kv, on_state) -> dict:
    """Rebuild a decode cache applying ``on_kv(entry, axis)`` to ``KVCache``
    entries and ``on_state(entry)`` to recurrent states; ``pos`` is kept."""
    blocks = {
        n: on_kv(e, _kv_batch_axis(e)) if isinstance(e, A.KVCache) else on_state(e)
        for n, e in cache["blocks"].items()
    }
    prefix = [on_kv(e, _kv_batch_axis(e)) if isinstance(e, A.KVCache) else e
              for e in cache["prefix"]]
    return {"prefix": prefix, "blocks": blocks, "pos": cache["pos"]}


def cache_resize(cfg: ModelConfig, cache: dict, new_batch: int) -> dict:
    """Pad (with zero rows) or slice the cache's batch/slot axis to
    ``new_batch`` rows.  Surviving rows keep their contents; lengths and
    the decode clock are untouched."""

    def resize(x, axis):
        cur = x.shape[axis]
        if cur == new_batch:
            return x.clone()
        if cur < new_batch:
            shape = list(x.shape)
            shape[axis] = new_batch - cur
            return torch.cat([x, x.new_zeros(shape)], dim=axis)
        return x.narrow(axis, 0, new_batch).clone()

    def on_kv(e, ax):
        return e._replace(**{f: resize(getattr(e, f), ax) for f in _KV_FIELDS})

    # recurrent states ([G, B, ...] leaves) resize on axis 1
    return _cache_map(cache, on_kv, lambda e: type(e)(*(resize(x, 1) for x in e)))


def cache_install_rows(
    cfg: ModelConfig,
    dst: dict,
    src: dict,
    dst_rows: list[int],
    src_rows: list[int],
    *,
    shift: int = 0,
) -> dict:
    """Copy prefilled cache rows ``src_rows`` of ``src`` into slots
    ``dst_rows`` of ``dst``, in place; returns ``dst``'s tensors in a new
    cache dict.

    ``shift`` right-rolls the KV time axis of the copied rows first
    (``attention.roll_kv``) so a prompt prefilled at bucket width L aligns
    with a running decode clock T = L + shift: its last real token lands
    at slot T-1 and the rolled-in garbage sits below the row's (grown) left
    pad, which the pad_lens mask already excludes.  Recurrent states have
    no time axis and copy rows directly."""

    def put(d, s, axis, roll=0):
        d_idx = torch.as_tensor(dst_rows, dtype=torch.long, device=d.device)
        s_idx = torch.as_tensor(src_rows, dtype=torch.long, device=s.device)
        rows = s.index_select(axis, s_idx)
        if roll:  # the time axis is third from the end in every KV layout
            rows = torch.roll(rows, roll, dims=rows.ndim - 3)
        return d.index_copy_(axis, d_idx, rows.to(d.device))

    def on_kv(pair, ax):
        d, s = pair
        return d._replace(**{f: put(getattr(d, f), getattr(s, f), ax, shift)
                             for f in _KV_FIELDS})

    def on_state(pair):
        d, s = pair
        return type(d)(*(put(dx, sx, 1) for dx, sx in zip(d, s)))

    paired = {
        "prefix": [(d, s) for d, s in zip(dst["prefix"], src["prefix"])],
        "blocks": {n: (e, src["blocks"][n]) for n, e in dst["blocks"].items()},
    }
    blocks = {n: on_kv(pair, _kv_batch_axis(pair[0])) if isinstance(pair[0], A.KVCache)
              else on_state(pair) for n, pair in paired["blocks"].items()}
    prefix = [on_kv(pair, _kv_batch_axis(pair[0])) if isinstance(pair[0], A.KVCache)
              else pair[0] for pair in paired["prefix"]]
    return {"prefix": prefix, "blocks": blocks, "pos": dst["pos"]}


def cache_set_clock(cfg: ModelConfig, cache: dict, clock: int) -> dict:
    """Set the shared decode write position: ``pos`` and every KV length.
    Continuous batching keeps all slots on one physical clock; per-slot
    logical lengths live in the scheduler's ``pad_lens``."""
    clock = int(clock)
    out = _cache_map(cache, lambda e, ax: e._replace(length=clock), lambda e: e)
    out["pos"] = clock
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_layer(cfg: ModelConfig, lp: dict, kind: str, fk: str, x: torch.Tensor, *,
                 positions, cache=None, mode: str = "full", pad_lens=None, token_mask=None):
    """One layer: an attention or Mamba mixer and a dense or MoE FFN
    (``fk``), or an rwkv time-mix and channel-mix.  Returns (x, the new cache
    entry): the KV cache written in place, or a new ``RWKVState`` or
    ``MambaState`` (None without a cache)."""
    # fused sites absorb their pre-norm (unified-datapath prologue): pass
    # the raw residual stream and let the kernel run the norm statistics
    h = x if F.carries_norm(lp["mixer"]) else L.norm(lp["mixer_norm"], x)
    new_cache = None
    with trace.part("mixer", kind=kind):
        if kind == "rwkv":
            out, wkv, tshift = R.rwkv_time_mix(lp["mixer"], cfg, h, state=cache, mode=mode)
        elif kind == "mamba":
            out, st = S.mamba_mixer(lp["mixer"], cfg, h, state=cache, mode=mode)
            new_cache = st if cache is not None else None
        else:
            attend = A.mla_attention if cfg.mla else A.gqa_attention
            out, kv_new = attend(lp["mixer"], cfg, h, causal=True, positions=positions,
                                 cache=cache, mode=mode, pad_lens=pad_lens)
            new_cache = kv_new if cache is not None else None
    if "ls1" in lp:
        out = out * lp["ls1"].to(out.dtype)
    x = x + out
    h = x if F.carries_norm(lp["ffn"]) else L.norm(lp["ffn_norm"], x)
    with trace.part("ffn", kind=fk):
        if kind == "rwkv":
            out, cshift = R.rwkv_channel_mix(lp["ffn"], cfg, h,
                                             prev=cache.cshift if cache is not None else None)
            if cache is not None:
                new_cache = R.RWKVState(tshift=tshift.to(torch.float32),
                                        cshift=cshift.to(torch.float32), wkv=wkv)
        elif fk == "moe":
            out = F.moe_ffn(lp["ffn"], cfg, h, token_mask=token_mask)
        else:
            out = F.dense_ffn(lp["ffn"], cfg.act, h)
    if "ls2" in lp:
        out = out * lp["ls2"].to(out.dtype)
    return x + out, new_cache


def _embed_inputs(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    if cfg.embed_inputs:
        x = L.dense(params["in_proj"], inputs)
    else:
        x = L.embed(params["embed"]["w"], inputs)
    if cfg.pos == "sincos":
        d = cfg.d_model
        i = torch.arange(d // 2, dtype=torch.float32, device=x.device)
        ang = positions[..., None].to(torch.float32) / (10_000.0 ** (2 * i / d))
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        if "pos_rot" in params:  # rotated-stream models fold H into the table
            pe = pe @ params["pos_rot"].to(torch.float32)
        x = x + pe.to(x.dtype)
    return x


def forward(
    cfg: ModelConfig,
    params: dict,
    inputs: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    mode: str = "full",
    pad_lens: Optional[torch.Tensor] = None,
    remat: bool | str = False,
    act_sharding=None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Full/prefill/decode forward.

    inputs: [B, L] int tokens (or [B, L, d] embeddings for stub frontends).
    ``remat`` (without a cache): activation-checkpoint each scan group
    (training memory), True or ``"dots"``/``"dots_saveable"`` to keep the
    matmul outputs too (``layers.remat``).
    ``act_sharding``: a ``parallel.sharding.NamedSharding`` the residual
    stream is redistributed to at every scan group's end (the reference's
    ``with_sharding_constraint``: DP batch, optionally TP-SP sequence; see
    ``sharding.act_pspec``); None leaves it where the ops put it.
    ``pad_lens``: [B] int LEFT-pad count per row — the serving engine's
    prompt-length buckets pad prompts on the left so the last real token
    always sits in the last slot.  Per-row RoPE positions shift back by the
    pad and pad key slots are masked out of every attention softmax, so
    real-token outputs match the unpadded forward (attention-only patterns:
    a recurrent mixer would carry the pad tokens through its state).  With
    ``cache`` the cache is written in place (``models/attention.py``; rwkv
    and Mamba states too) and returned with its clock advanced.  Returns
    (logits [B, L, V], new_cache).
    """
    if pad_lens is not None and any(k != "attn" for k in cfg.pattern):
        raise ValueError(f"pad_lens needs an attention-only layer pattern, got {cfg.pattern}")
    pos0 = int(cache["pos"]) if cache is not None else 0
    lq = inputs.shape[1]
    slots = (pos0 + torch.arange(lq, device=inputs.device))[None, :]
    positions = slots
    token_mask = None
    if pad_lens is not None:
        # logical positions: slot s of a row with p leading pads holds
        # token s - p (clamped for the masked pad slots themselves)
        positions = torch.clamp_min(slots - pad_lens[:, None], 0)
        # slot validity: the first pad_lens slots of a row are padding, which
        # MoE routing must not let take expert capacity (an idle decode slot,
        # pad max_len + 1, is masked whole)
        token_mask = slots >= pad_lens[:, None]
    x = _embed_inputs(cfg, params, inputs, positions)

    new_prefix = []
    for i, lp in enumerate(params["prefix"]):
        c = cache["prefix"][i] if cache is not None else None
        x, c2 = _apply_layer(cfg, lp, mixer_kind(cfg, i), ffn_kind(cfg, i), x,
                             positions=positions, cache=c, mode=mode, pad_lens=pad_lens,
                             token_mask=token_mask)
        new_prefix.append(c2)

    period = len(cfg.pattern)
    # the reference's scan body takes each pattern position's FFN kind from
    # the first group (``ffn_kind(first_dense + j)``)
    fks = [ffn_kind(cfg, cfg.first_dense + j) for j in range(period)]
    kw = dict(positions=positions, mode=mode, pad_lens=pad_lens, token_mask=token_mask)
    new_blocks = {}
    if cache is None:
        def group(gp, xc):
            for j in range(period):
                xc, _ = _apply_layer(cfg, gp[f"l{j}"], cfg.pattern[j], fks[j], xc, **kw)
            return L.constrain(xc, act_sharding)

        for g in range(n_scan_groups(cfg)):  # the reference's lax.scan over groups
            x = L.remat(functools.partial(group, tree_index(params["blocks"], g)), remat)(x)
    else:
        for g in range(n_scan_groups(cfg)):
            gp = tree_index(params["blocks"], g)
            for j in range(period):
                name, kind = f"l{j}", cfg.pattern[j]
                full = cache["blocks"][name]
                if kind == "attn":
                    c = A.KVCache(full.k[g], full.v[g], full.k_scale[g], full.v_scale[g],
                                  full.length)
                else:  # a recurrent state: the group's views of its [G, B, ...] leaves
                    c = type(full)(*(leaf[g] for leaf in full))
                x, c2 = _apply_layer(cfg, gp[name], kind, fks[j], x, cache=c, **kw)
                if kind == "attn":  # the group's view was written in place
                    new_blocks[name] = full._replace(length=c2.length)
                else:  # write the group's state in place
                    for view, new in zip(c, c2):
                        view.copy_(new)
                    new_blocks[name] = full
            x = L.constrain(x, act_sharding)

    with trace.part("lm_head"):
        x = L.norm(params["final_norm"], x)
        if cfg.tie_embeddings:
            logits = torch.einsum("bld,vd->blv", x, params["embed"]["w"].to(x.dtype))
        else:
            logits = L.dense(params["lm_head"], x)
    new_cache = None
    if cache is not None:
        new_cache = {"prefix": new_prefix, "blocks": new_blocks, "pos": pos0 + lq}
    return logits, new_cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, cache: dict,
                pad_lens: Optional[torch.Tensor] = None):
    """One-token decode: token [B] int (or [B, 1, d] embeddings).
    ``pad_lens``: [B] left-pad counts carried over from a bucketed prefill."""
    if not cfg.embed_inputs and token.ndim == 1:
        token = token[:, None]
    return forward(cfg, params, token, cache=cache, mode="decode", pad_lens=pad_lens)
