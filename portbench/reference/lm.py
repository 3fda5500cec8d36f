"""Plain reference of a dense decoder LM (RMSNorm, RoPE, multi-head or
grouped-query attention, SwiGLU) served at W4A8 (VersaQ): the last
position's logits of one prompt's prefill.

The stream lives rotated by a blocked Hadamard (the embedding table is
rotated); RMSNorm statistics are rotation-free, their gamma folds into
the consumers; Q, K, V, O, gate, up and down are W4 per output channel
with the 64-point DCT on the output side and A8 per-token inputs; V and O
carry a per-head Hadamard pair; Q and K take an online per-head WHT
after RoPE; the down projection's input takes an online WHT.  Prefill
writes K and V to an int8 cache (per token and head), so attention reads
them dequantized; the softmax is float32 and causal.  The final norm and
the output head stay float32.

``raw``: the plain dict of the seed-made weights (``embed``, ``blocks`` =
``{"l0": {...}}`` stacked along a leading layer axis, ``final_norm``,
``lm_head``); ``cfg``: ``d_model``, ``n_heads``, ``n_kv_heads``,
``head_dim``, ``rope_theta``.  Runs layer by layer over a list of prompts.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.quant import Site, block_of, hadamard, quant_tokens, rms, rows_times, wht


def _leaf(tree, i):
    return {k: (_leaf(v, i) if isinstance(v, dict) else (None if v is None else v[i]))
            for k, v in tree.items()}


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the (first half, second half) pairs of x [L, H, dh]; the
    frequencies 1/theta**(i/dh) rounded to float32 from float64."""
    dh = x.shape[-1]
    i = torch.arange(0, dh, 2, dtype=torch.float64, device=x.device)
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64, device=x.device),
                          i / dh).to(torch.float32)
    ang = pos[:, None].to(torch.float32) * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _layer_sites(lp: dict, cfg: dict) -> dict:
    d, h, hkv, dh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    mx, ff = lp["mixer"], lp["ffn"]
    g1, g2 = lp["mixer_norm"]["g"], lp["ffn_norm"]["g"]
    blk = block_of(d)
    dff = ff["w_up"]["w"].shape[1]
    return {
        "q": Site(mx["wq"]["w"], bias=mx["wq"].get("b"), gamma=g1, rotate_in=blk),
        "k": Site(mx["wk"]["w"], bias=mx["wk"].get("b"), gamma=g1, rotate_in=blk),
        "v": Site(mx["wv"]["w"], bias=mx["wv"].get("b"), gamma=g1, rotate_in=blk,
                  head_out=(hkv, dh)),
        "o": Site(mx["wo"]["w"], bias=mx["wo"].get("b"), head_in=(h, dh), rotate_out=blk),
        "gate": Site(ff["w_gate"]["w"], gamma=g2, rotate_in=blk),
        "up": Site(ff["w_up"]["w"], gamma=g2, rotate_in=blk),
        "down": Site(ff["w_down"]["w"], rotate_in=block_of(dff), online_wht=block_of(dff),
                     rotate_out=blk),
    }


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rows: int = 1024) -> torch.Tensor:
    """Causal float32 softmax attention of q [L, H, dh] over k, v
    [L, Hkv, dh], query rows in blocks."""
    n, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).permute(1, 2, 0)  # [H, dh, L]
    v = v.repeat_interleave(g, dim=1).permute(1, 0, 2)  # [H, L, dh]
    qh = (q / math.sqrt(dh)).permute(1, 0, 2)  # [H, L, dh]
    out = torch.empty_like(qh)
    cols = torch.arange(n, device=q.device)
    for r0 in range(0, n, rows):
        s = qh[:, r0:r0 + rows] @ k
        keep = (r0 + torch.arange(s.shape[1], device=q.device))[:, None] >= cols[None, :]
        s = torch.where(keep, s, torch.tensor(-1e30, device=q.device))
        out[:, r0:r0 + rows] = torch.softmax(s, dim=-1) @ v
    return out.permute(1, 0, 2)


@torch.no_grad()
def last_logits(raw: dict, cfg: dict, prompts: list[torch.Tensor], a_bits: int = 8
                ) -> torch.Tensor:
    """[len(prompts), vocab] float32 logits at each prompt's last position."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    d, h, hkv, dh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    dev = raw["embed"]["w"].device
    hb = hadamard(block_of(d), dev)
    emb = raw["embed"]["w"].float()
    xs = [(emb[p.to(dev).long()].reshape(-1, d // hb.shape[0], hb.shape[0]) @ hb).reshape(-1, d)
          for p in prompts]
    n_layers = raw["blocks"]["l0"]["mixer_norm"]["g"].shape[0]
    for i in range(n_layers):
        s = _layer_sites(_leaf(raw["blocks"]["l0"], i), cfg)
        for j, x in enumerate(xs):
            n = x.shape[0]
            pos = torch.arange(n, device=dev)
            a = rms(x)
            q = _rope(s["q"](a, a_bits).reshape(n, h, dh), pos, cfg["rope_theta"])
            k = _rope(s["k"](a, a_bits).reshape(n, hkv, dh), pos, cfg["rope_theta"])
            v = s["v"](a, a_bits).reshape(n, hkv, dh)
            q, k = wht(q, block_of(dh)), wht(k, block_of(dh))
            kq, kscale = quant_tokens(k, 8)  # the int8 KV cache
            vq, vscale = quant_tokens(v, 8)
            o = _attend(q, kq * kscale, vq * vscale).reshape(n, h * dh)
            x = x + s["o"](o, a_bits)
            a = rms(x)
            hidden = torch.nn.functional.silu(s["gate"](a, a_bits)) * s["up"](a, a_bits)
            xs[j] = x + s["down"](hidden, a_bits)
        del s
    head = rows_times(hb, raw["final_norm"]["g"].float()[:, None] * raw["lm_head"]["w"].float())
    last = torch.stack([rms(x[-1]) for x in xs])
    out = last @ head
    if raw["lm_head"].get("b") is not None:
        out = out + raw["lm_head"]["b"]
    return out
