"""Plain reference of VGGT served at W4A8 (VersaQ, paper Fig. 5/6) with
two-stage INT8 attention (Alg. 1).

The residual stream lives rotated by a blocked Hadamard H; every
LayerNorm runs its statistics in that domain with gamma and beta folded
into the consumers; each projection is W4 per output channel after the
offline transforms (H on the input side, the 64-point DCT on the output
side, per-head Hadamards on V and O, LayerScale into O and the FFN's down
projection) and takes A8 per-token activations; the FFN hidden takes an
online WHT before its quantization.  Attention quantizes Q and K per
(token, head) and V per head to int8, forms p = exp(s - max), rounds
127 p to int8 and sums P V exactly.  The camera and DPT heads stay
float32.

``raw`` is the plain dict of the seed-made float weights (norms as
``{"g", "b"}``; the AA pairs stacked along a leading axis of 24);
``cfg`` a dict with ``d_model``, ``n_heads``, ``d_ff`` and
``n_special_tokens``.  Runs layer by layer over a list of scenes, so the
stream of every scene and one layer's weights are all it holds.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.quant import Site, block_of, blocked, exact_pv, hadamard, ln_rotated
from portbench.reference.quant import quant_tokens, wht


def _leaf(tree, i):
    return {k: (_leaf(v, i) if isinstance(v, dict) else (None if v is None else v[i]))
            for k, v in tree.items()}


def _block_sites(bp: dict, d: int, h: int, a_bits: int) -> dict:
    dh = d // h
    at, ff = bp["attn"], bp["ffn"]
    g1, b1 = bp["attn_norm"]["g"], bp["attn_norm"]["b"]
    g2, b2 = bp["ffn_norm"]["g"], bp["ffn_norm"]["b"]
    blk = block_of(d)
    qkv = [Site(at[n]["w"], bias=at[n]["b"], gamma=g1, beta=b1, rotate_in=blk,
                head_out=(h, dh) if n == "wv" else None) for n in ("wq", "wk", "wv")]
    dff = ff["w_up"]["w"].shape[1]
    return {
        "qkv": qkv,
        "wo": Site(at["wo"]["w"], bias=at["wo"]["b"], out_scale=bp["ls1"], head_in=(h, dh),
                   rotate_out=blk),
        "up": Site(ff["w_up"]["w"], bias=ff["w_up"]["b"], gamma=g2, beta=b2, rotate_in=blk),
        "down": Site(ff["w_down"]["w"], bias=ff["w_down"]["b"], out_scale=bp["ls2"],
                     rotate_in=block_of(dff), online_wht=block_of(dff), rotate_out=blk),
    }


def two_stage_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_rows: int = 4096) -> torch.Tensor:
    """Alg. 1 over [G, L, dh] heads (each its own sequence): int8 Q, K per
    token, V per head; s dequantized as s_int * qs * ks / sqrt(dh); p =
    exp(s - max); out = sum(round(127 p) v_int) / 127 / sum(p) * vs."""
    dh = q.shape[-1]
    qv, qs = quant_tokens(q, 8)
    kv, ks = quant_tokens(k, 8)
    vs = v.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-8) / 127.0
    vv = torch.round(v / vs).clamp(-127, 127)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dh)
    rows = min(q_rows, q.shape[1])
    step = max(1, (q_rows * 8192) // (rows * k.shape[1]))  # heads whose scores fit ~128 MiB
    kt, kst = kv.transpose(-1, -2), ks.transpose(-1, -2)
    for g0 in range(0, q.shape[0], step):
        g = slice(g0, g0 + step)
        for r0 in range(0, q.shape[1], q_rows):
            r = slice(r0, r0 + q_rows)
            s = qv[g, r] @ kt[g]  # exact: |s| <= 127 * 127 * dh
            s.mul_(qs[g, r]).mul_(kst[g]).mul_(scale)
            s.sub_(s.amax(dim=-1, keepdim=True)).exp_()  # p, in place
            l = s.sum(dim=-1, keepdim=True)
            s.mul_(127.0).round_()  # pq
            out[g, r] = exact_pv(s, vv[g]) * (1.0 / 127.0) / l.clamp_min(1e-30) * vs[g]
            del s
    return out


def _block(sites: dict, x: torch.Tensor, d: int, h: int, a_bits: int) -> torch.Tensor:
    """One attention + FFN block over x [G, L, d] (G independent sequences)."""
    dh = d // h
    g, n, _ = x.shape
    a = ln_rotated(x, d, block_of(d))
    q, k, v = (site(a, a_bits).reshape(g, n, h, dh) for site in sites["qkv"])
    q, k = wht(q, block_of(dh)), wht(k, block_of(dh))
    heads = [t.permute(0, 2, 1, 3).reshape(g * h, n, dh) for t in (q, k, v)]
    o = two_stage_heads(*heads).reshape(g, h, n, dh).permute(0, 2, 1, 3).reshape(g, n, d)
    x = x + sites["wo"](o, a_bits)
    a = ln_rotated(x, d, block_of(d))
    hidden = torch.nn.functional.gelu(sites["up"](a, a_bits), approximate="tanh")
    return x + sites["down"](hidden, a_bits)


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y if p.get("b") is None else y + p["b"]


@torch.no_grad()
def forward(raw: dict, cfg: dict, scenes: list[torch.Tensor], a_bits: int = 8) -> list[dict]:
    """Reference outputs (pose, depth, points, conf) of each scene [S, P, d_in]."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    d, h, ns = cfg["d_model"], cfg["n_heads"], cfg["n_special_tokens"]
    dev = scenes[0].device
    hb = hadamard(block_of(d), dev)
    pp = raw["patch_proj"]
    w_in = blocked(pp["w"].float(), hb)
    b_in = None if pp.get("b") is None else blocked(pp["b"].float(), hb)
    spec = blocked(raw["special_tokens"].float(), hb)
    xs = []
    for sc in scenes:
        x = sc.float() @ w_in + (0 if b_in is None else b_in)
        s = x.shape[0]
        xs.append(torch.cat([spec.expand(s, ns, d), x], dim=1))  # [S, T, d]
    n_pairs = raw["blocks"]["frame"]["ls1"].shape[0]
    for i in range(n_pairs):
        for kind in ("frame", "global"):
            sites = _block_sites(_leaf(raw["blocks"][kind], i), d, h, a_bits)
            for j, x in enumerate(xs):
                s, t, _ = x.shape
                seqs = x if kind == "frame" else x.reshape(1, s * t, d)
                xs[j] = _block(sites, seqs, d, h, a_bits).reshape(s, t, d)
            del sites
    fn = raw["final_norm"]
    outs = []
    for x in xs:
        # the final LayerNorm in the clear, then the float heads
        xn = torch.nn.functional.layer_norm(blocked(x, hb), (d,), fn["g"], fn["b"], eps=1e-6)
        ch, dp = raw["camera_head"], raw["dpt_head"]
        pose = _dense(ch["fc2"], torch.tanh(_dense(ch["fc1"], xn[:, 0])))
        feat = torch.nn.functional.gelu(_dense(dp["fc1"], xn[:, ns:]), approximate="tanh")
        o = _dense(dp["fc2"], feat)
        outs.append({"pose": pose, "points": o[..., :3], "depth": o[..., 3],
                     "conf": torch.sigmoid(o[..., 4])})
    return outs
