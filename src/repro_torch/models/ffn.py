"""Feed-forward mixers (port of ``repro/models/ffn.py``): dense GLU/GELU,
the unified datapath's ``FusedFFN``, and the fine-grained MoE.

MoE is capacity-based with gather dispatch, as in the reference: each
token's top-k experts take it into a slot of their ``[E, cap, d]`` buffer
(rank order by a token-major running count; overflow goes to a scratch slot
that is cut off), every expert runs on its whole buffer (zero rows where a
slot is empty), and the gated outputs come back to their tokens.  The
router runs in f32.  Three things differ in form, not in result:

* the dispatch blocks of a layer run as one batch (a leading block axis),
  not under ``vmap``; a quantized layer's routed experts are one batched
  ``quant_matmul`` launch per projection (``core/versaq.apply_linear``);
* the combine gathers each token's <= k contributions and adds them in
  ascending expert order, the order of the reference's scatter-add, so no
  atomics reorder the float sum from run to run;
* capacity from the real-token count stays on the device (no host sync).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.versaq import FusedFFN, apply_ffn, carries_norm
from repro_torch.models import layers as L
from repro_torch.sharded import routed

__all__ = ["init_dense_ffn", "dense_ffn", "carries_norm", "init_moe", "moe_ffn",
           "moe_aux_loss"]


def init_dense_ffn(
    generator: torch.Generator, d_model: int, d_ff: int, act: str, dtype=torch.float32, device=None
) -> dict:
    kw = dict(dtype=dtype, device=device)
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": L.init_linear(generator, d_model, d_ff, **kw),
            "w_up": L.init_linear(generator, d_model, d_ff, **kw),
            "w_down": L.init_linear(generator, d_ff, d_model, **kw),
        }
    return {
        "w_up": L.init_linear(generator, d_model, d_ff, bias=True, **kw),
        "w_down": L.init_linear(generator, d_ff, d_model, bias=True, **kw),
    }


def dense_ffn(p, act: str, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p, FusedFFN):
        # unified datapath: the whole layer (with the norm prologue when
        # ``carries_norm(p)`` — the caller passes the raw stream) is one
        # kernel launch; see core/versaq.apply_ffn
        return apply_ffn(p, x)
    if "w_gate" in p:
        g = L.dense(p["w_gate"], x)
        u = L.dense(p["w_up"], x)
        h = (L.silu(g) if act == "swiglu" else L.gelu(g)) * u
        return L.dense(p["w_down"], h)
    h = L.gelu(L.dense(p["w_up"], x))
    return L.dense(p["w_down"], h)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    """Stacked routed experts ``[E, d, d_ff]`` / ``[E, d_ff, d]``, the router
    and, with ``n_shared_experts``, one dense FFN of that many experts' width."""
    e, d = cfg.n_experts, cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff

    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)

    experts = {}
    if cfg.act in ("swiglu", "geglu"):
        experts["w_gate"] = draw((e, d, dff), 1.0 / math.sqrt(d))
    experts["w_up"] = draw((e, d, dff), 1.0 / math.sqrt(d))
    experts["w_down"] = draw((e, dff, d), 1.0 / math.sqrt(dff))
    p = {"router": L.init_linear(generator, d, e, dtype=dtype, device=device),
         "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = init_dense_ffn(generator, d, cfg.n_shared_experts * dff, cfg.act,
                                     dtype=dtype, device=device)
    return p


def _cap(cfg: ModelConfig, n):
    """ceil(n·k·cf/e), cf quantized to quarters; ``n`` an int or an int tensor."""
    num = n * cfg.top_k * int(4 * cfg.capacity_factor)
    den = 4 * cfg.n_experts
    if isinstance(num, torch.Tensor):
        return -torch.div(-num, den, rounding_mode="floor")
    return -(-num // den)


def _expert_mm(w, xin: torch.Tensor) -> torch.Tensor:
    """One projection of every expert on its buffer: xin [nb, E, cap, K]."""
    if isinstance(w, torch.Tensor):  # full-precision stacked experts
        return torch.einsum("becd,edf->becf", xin.to(torch.float32), w.to(torch.float32))
    return L.dense(w, xin)  # VersaQ-quantized, expert-stacked: one batched launch


def _moe_block(p: dict, cfg: ModelConfig, xt: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Route dispatch blocks of tokens ``xt`` [nb, tb, d] (or one block
    [tb, d]) through their top-k experts; returns f32 of ``xt``'s shape.

    ``mask`` ([nb, tb] or [tb] bool) marks *real* tokens.  Masked-out tokens
    (the serving engine's LEFT-pad slots, an idle decode slot) are excluded
    from routing: they take no expert capacity and get nothing back, and
    each block's capacity follows its real-token count, so real tokens keep
    the slots they would get in the unpadded forward."""
    one = xt.ndim == 2
    if one:
        xt = xt[None]
        mask = None if mask is None else mask[None]
    nb, tb, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    cap = min(max(1, _cap(cfg, tb)), tb)  # static: buffer slots

    logits = L.dense(p["router"], xt).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)  # [nb, tb, k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # capacity-based slotting: rank of each (token, expert) assignment in a
    # token-major running count per expert
    flat_e = idx.reshape(nb, tb * k)
    onehot = torch.nn.functional.one_hot(flat_e, e).to(torch.int32)  # [nb, tb*k, e]
    valid = None
    if mask is not None:
        valid = mask.to(torch.bool).repeat_interleave(k, dim=1)  # [nb, tb*k]
        onehot = onehot * valid[..., None].to(torch.int32)  # pads rank-invisible
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    my_rank = torch.gather(rank, 2, flat_e[..., None])[..., 0]
    del onehot, rank
    if mask is None:
        keep = my_rank < cap
    else:
        # the formula the unpadded forward applies to the real-token count
        # (on the device: <= the static cap, both terms monotone in n)
        n_real = mask.to(torch.int32).sum(dim=1, keepdim=True)
        cap_eff = torch.minimum(torch.clamp_min(_cap(cfg, n_real), 1), n_real)
        keep = (my_rank < cap_eff) & valid
    token_id = torch.arange(tb, device=dev).repeat_interleave(k)  # [tb*k]
    slot = torch.where(keep, my_rank.long(), cap)  # overflow -> scratch slot
    bidx = torch.arange(nb, device=dev)[:, None].expand(nb, tb * k)

    # gather tokens into [nb, e, cap+1, d] (the last slot is the overflow
    # bin, whose duplicate writes all carry the pad row; it is cut off)
    buf_idx = torch.full((nb, e, cap + 1), tb, dtype=torch.long, device=dev)
    buf_idx[bidx, flat_e, slot] = torch.where(keep, token_id, tb)  # tb == zero pad row
    xt_pad = torch.cat([xt, xt.new_zeros((nb, 1, d))], dim=1)
    xe = xt_pad[torch.arange(nb, device=dev)[:, None, None], buf_idx[:, :, :cap]]

    ex = p["experts"]
    up = _expert_mm(ex["w_up"], xe)
    if "w_gate" in ex:
        g = _expert_mm(ex["w_gate"], xe)
        h = (L.silu(g) if cfg.act == "swiglu" else L.gelu(g)) * up
    else:
        h = L.gelu(up)
    ye = _expert_mm(ex["w_down"], h.to(xt.dtype)).to(torch.float32)  # [nb, e, cap, d]
    del xe, up, h

    # combine: each assignment's gated output, gathered back to its token
    # and summed in ascending expert order (the reference scatter-adds the
    # [e, cap] buffer in that order)
    part = ye[bidx, flat_e, slot.clamp_max(cap - 1)] * gate.reshape(nb, tb * k, 1)
    part = torch.where(keep[..., None], part, 0.0).reshape(nb, tb, k, d)
    order = torch.argsort(idx, dim=-1)
    part = torch.gather(part, 2, order[..., None].expand(nb, tb, k, d))
    out = part[:, :, 0]
    for j in range(1, k):
        out = out + part[:, :, j]
    return out[0] if one else out


@routed
def moe_dispatch(p: dict, cfg: ModelConfig, xt: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`_moe_block` (on a sharded path ``parallel.sites.moe_dispatch``,
    which routes each rank's dispatch blocks)."""
    return _moe_block(p, cfg, xt, mask)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor,
            token_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k routed experts + always-on shared experts (DeepSeekMoE §3).

    Dispatch runs in token blocks (``cfg.moe_dispatch_blocks``, or one per
    ~4096 tokens): rank order and capacity are block-local.  ``token_mask``
    [B, L] bool marks real tokens; padded slots are excluded from routing
    and capacity and get only the shared experts' output, which the caller
    discards with the rest of the padded positions."""
    b, l, d = x.shape
    t = b * l
    nb = cfg.moe_dispatch_blocks or max(1, t // 4096)
    while t % nb:
        nb -= 1
    mt = None if token_mask is None else L.reshape(token_mask, (nb, t // nb))
    y = L.reshape(moe_dispatch(p, cfg, L.reshape(x, (nb, t // nb, d)), mt),
                  (b, l, d)).to(x.dtype)
    if "shared" in p:
        y = y + dense_ffn(p["shared"], cfg.act, x)
    return y


def moe_aux_loss(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f·P)."""
    t = x.shape[0] * x.shape[1]
    logits = L.dense(p["router"], x.reshape(t, -1)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    _, idx = torch.topk(probs, cfg.top_k, dim=-1)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts).to(torch.float32)
    f = counts / torch.clamp_min(counts.sum(), 1.0)
    return cfg.n_experts * torch.sum(f * probs.mean(dim=0))
