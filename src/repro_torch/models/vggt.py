"""VGGT: Visual Geometry Grounded Transformer (the paper's target model) —
port of ``repro/models/vggt.py``.

* DINO feature extraction is a STUB frontend: inputs are precomputed
  patch embeddings [B, S, P, d_in].
* Per-frame special tokens (camera + register) are learned and prepended.
* The Alternating-Attention backbone interleaves frame-wise attention
  (tokens as [B·S, T, C]) and global attention ([B, S·T, C]).
* LayerScale on every residual branch (folded into the output
  projections by the VersaQ flow).
* Heads: camera (9-DoF pose from the camera token) and a DPT-style head
  (per-patch depth + 3D points + confidence).

The stacked group axis of ``params["blocks"]`` is kept as in the
reference; its ``lax.scan`` becomes a Python loop that indexes the group.
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.obs import trace
from repro_torch.tree import tree_index, tree_leaves, tree_stack

__all__ = ["N_POSE", "init_params", "token_mask", "forward", "reconstruction_loss"]

N_POSE = 9  # rotation quaternion (4) + translation (3) + focal (2)


def _init_attn_block(generator, cfg: ModelConfig, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "attn_norm": L.init_norm(cfg.d_model, kind="ln", bias=True, **kw),
        "attn": A.init_gqa(generator, cfg, **kw),
        "ffn_norm": L.init_norm(cfg.d_model, kind="ln", bias=True, **kw),
        "ffn": F.init_dense_ffn(generator, cfg.d_model, cfg.d_ff, cfg.act, **kw),
        "ls1": torch.full((cfg.d_model,), cfg.layerscale_init, **kw),
        "ls2": torch.full((cfg.d_model,), cfg.layerscale_init, **kw),
    }


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device=None, dtype=torch.float32
) -> dict:
    """Random weights drawn from ``generator`` (which must live on
    ``device``); blocks are stacked along a leading group axis."""
    if not cfg.vggt:
        raise ValueError(f"{cfg.name} is not a VGGT config")
    device = generator.device if device is None else torch.device(device)
    kw = dict(dtype=dtype, device=device)
    pairs = [
        {
            "frame": _init_attn_block(generator, cfg, dtype, device),
            "global": _init_attn_block(generator, cfg, dtype, device),
        }
        for _ in range(cfg.n_layers)
    ]
    d = cfg.d_model
    special = torch.randn((cfg.n_special_tokens, d), generator=generator, device=device) * 0.02
    return {
        "patch_proj": L.init_linear(generator, d, d, bias=True, **kw),
        "special_tokens": special.to(dtype),
        "blocks": tree_stack(pairs),
        "final_norm": L.init_norm(d, kind="ln", bias=True, **kw),
        "camera_head": {
            "fc1": L.init_linear(generator, d, d, bias=True, **kw),
            "fc2": L.init_linear(generator, d, N_POSE, bias=True, **kw),
        },
        "dpt_head": {
            "fc1": L.init_linear(generator, d, d, bias=True, **kw),
            "fc2": L.init_linear(generator, d, 3 + 1 + 1, bias=True, **kw),  # xyz, depth, conf
        },
    }


def _block(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_mask=None) -> torch.Tensor:
    # fused sites absorb their pre-norm (unified-datapath prologue)
    h = x if F.carries_norm(p["attn"]) else L.norm(p["attn_norm"], x)
    with trace.part("attn"):
        out, _ = A.gqa_attention(p["attn"], cfg, h, causal=False, mode="full", kv_mask=kv_mask)
    x = x + out * p["ls1"].to(out.dtype) if "ls1" in p else x + out
    h = x if F.carries_norm(p["ffn"]) else L.norm(p["ffn_norm"], x)
    with trace.part("ffn"):
        out = F.dense_ffn(p["ffn"], cfg.act, h)
    x = x + out * p["ls2"].to(out.dtype) if "ls2" in p else x + out
    return x


def token_mask(
    cfg: ModelConfig,
    b: int,
    s: int,
    p_: int,
    patch_mask: torch.Tensor | None,
    frame_mask: torch.Tensor | None,
    device=None,
) -> torch.Tensor | None:
    """[B, S, T] bool validity mask (special tokens valid iff their frame
    is), or None when nothing is padded."""
    if patch_mask is None and frame_mask is None:
        return None
    ns = cfg.n_special_tokens
    pm = (
        torch.ones((b, s, p_), dtype=torch.bool, device=device)
        if patch_mask is None
        else patch_mask.to(torch.bool)
    )
    fm = (
        torch.ones((b, s), dtype=torch.bool, device=device)
        if frame_mask is None
        else frame_mask.to(torch.bool)
    )
    pm = pm & fm[:, :, None]
    spec = fm[:, :, None].expand(b, s, ns)
    return torch.cat([spec, pm], dim=2)


def forward(
    cfg: ModelConfig,
    params: dict,
    patch_embeds: torch.Tensor,
    *,
    patch_mask: torch.Tensor | None = None,
    frame_mask: torch.Tensor | None = None,
    remat: bool | str = False,
    act_sharding=None,
) -> dict[str, Any]:
    """patch_embeds: [B, S, P, d] (stub DINO features).

    ``patch_mask`` [B, S, P] / ``frame_mask`` [B, S] (bool) mark padded
    patches/frames added by the serving engine's shape buckets: masked
    tokens are excluded from every attention softmax, so valid-token
    outputs equal the unpadded forward; head outputs at masked positions
    are garbage and must be sliced off by the caller.

    ``remat``: activation-checkpoint each AA pair (training memory: only
    the stream between pairs is kept), True or ``"dots"`` to keep the
    matmul outputs too (``layers.remat``).

    ``act_sharding``: a ``parallel.sharding.NamedSharding`` the [B, S, T,
    d] stream is redistributed to after every AA pair (the reference's
    ``with_sharding_constraint``); None leaves it where the ops put it.

    Returns dict with pose [B,S,9], depth [B,S,P], points [B,S,P,3],
    conf [B,S,P], tokens [B,S,T,d].

    Traced (inside a ``parts=True`` span, ``obs.trace``): an ``attn`` and
    an ``ffn`` part per block (labels ``kind``, frame or global, and
    ``pair``), and the ``heads`` part.
    """
    b, s, p_, d = patch_embeds.shape
    ns = cfg.n_special_tokens
    x = L.dense(params["patch_proj"], patch_embeds)
    spec = params["special_tokens"].expand(b, s, ns, d).to(x.dtype)
    x = torch.cat([spec, x], dim=2)  # [B, S, T, d], T = ns + P
    t = ns + p_
    tmask = token_mask(cfg, b, s, p_, patch_mask, frame_mask, device=x.device)
    fmask = None if tmask is None else tmask.reshape(b * s, t)
    gmask = None if tmask is None else tmask.reshape(b, s * t)

    def pair(gi, gp, xc):
        xc = _block(gp["frame"], cfg, L.reshape(xc, (b * s, t, d)), kv_mask=fmask)  # frame-wise
        trace.label_parts(kind="frame", pair=gi)
        xc = _block(gp["global"], cfg, L.reshape(xc, (b, s * t, d)), kv_mask=gmask)  # global
        trace.label_parts(kind="global", pair=gi)
        return L.constrain(L.reshape(xc, (b, s, t, d)), act_sharding)

    blocks = params["blocks"]
    for gi in range(tree_leaves(blocks)[0].shape[0]):
        x = L.remat(functools.partial(pair, gi, tree_index(blocks, gi)), remat)(x)
    with trace.part("heads"):
        x = L.norm(params["final_norm"], x)

        cam_tok = x[:, :, 0, :]  # [B, S, d]
        ch = params["camera_head"]
        pose = L.dense(ch["fc2"], torch.tanh(L.dense(ch["fc1"], cam_tok).float()).to(x.dtype))

        patch_tok = x[:, :, ns:, :]
        dh = params["dpt_head"]
        feat = L.gelu(L.dense(dh["fc1"], patch_tok).float()).to(x.dtype)
        out = L.dense(dh["fc2"], feat).float()
    return {
        "pose": pose.float(),
        "points": out[..., :3],
        "depth": out[..., 3],
        "conf": torch.sigmoid(out[..., 4]),
        "tokens": x,
    }


def reconstruction_loss(cfg: ModelConfig, params: dict, batch: dict, *,
                        remat: bool | str = False, act_sharding=None) -> torch.Tensor:
    """Multi-task training loss: the mean squared errors of pose, depth
    and points, summed.  ``batch``: ``scene_batch``'s arrays (numpy or
    tensors), taken to the parameters' device.  ``remat`` and
    ``act_sharding`` as :func:`forward` takes them."""
    dev = params["special_tokens"].device
    b = {k: torch.as_tensor(batch[k], device=dev) for k in ("patches", "pose", "depth", "points")}
    out = forward(cfg, params, b["patches"], remat=remat, act_sharding=act_sharding)
    lp = torch.mean((out["pose"] - b["pose"]) ** 2)
    ld = torch.mean((out["depth"] - b["depth"]) ** 2)
    lx = torch.mean((out["points"] - b["points"]) ** 2)
    return lp + ld + lx
