"""Whole-model VersaQ quantization (the paper's offline pipeline, Fig. 6)
— port of ``repro/core/model_quant.py``: ``quantize_vggt`` and, for
dense GQA, MLA, MoE, RWKV-6 and Mamba-hybrid LMs, ``quantize_lm``.

* The **residual stream is rotated once** (VGGT: H fused on the patch
  projection's output side, special tokens rotated; LM: E ← E·H on the
  embedding) and stays rotated.
* Every pre-norm becomes a ``FoldedNorm`` with its γ/β folded into every
  consumer; projections are fused per Eq. 7 and quantized per channel.
* V/O projections carry the per-head Hadamard pair; LayerScale folds into
  the output projections; the FFN hidden→down projection keeps the one
  online WHT.
* Heads (VGGT's camera/DPT heads, the LM's ``lm_head``) and MoE routers
  stay full precision and absorb the preceding norm; qk-norm and RoPE stay
  full precision.
* A MoE layer's routed experts are prepared per (scan group, expert) and
  stacked over both axes: one expert-stacked ``QuantLinear`` per projection,
  which the forward applies in one batched kernel launch.

* With ``PrecisionPlan(fuse=True)`` the unified datapath is built: Q/K/V
  merge into one ``wqkv`` site that absorbs the LayerNorm as its kernel
  prologue, ``wo`` runs its IDCT/bias in the kernel epilogue, and each
  dense FFN becomes one ``FusedFFN`` launch.

A uniform ``QuantPolicy``, a per-site ``PrecisionPlan`` and a compiled
``KernelSchedule`` (``core/precision/compiler.py``) are accepted.  With a
schedule, fusion decisions and kernel launch tiles are read from it
instead of decided inline.  The reference prepares stacked scan groups and
experts with ``vmap``; here each slice is prepared in a loop and the
results are stacked (``_vmapped``), which yields the same leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QTensor
from repro_torch.core.versaq import (
    Epilogue,
    FoldedNorm,
    FusedFFN,
    Norm,
    Prologue,
    QuantLinear,
    QuantPolicy,
    make_folded_norm,
    prepare_linear,
    prepare_linear_fp,
    rotate_cols,
)
from repro_torch.core import transforms
from repro_torch.models.lm import ffn_kind
from repro_torch.tree import tree_stack

__all__ = ["quantize_vggt", "quantize_lm", "FUSED_PANEL_BUDGET"]

_USE_WHT_METHODS = ("quarot", "versaq")


class _Resolver:
    """Uniform ``QuantPolicy`` or per-site ``PrecisionPlan`` behind one
    interface, duck-typed on ``policy_for`` (a plan) so this module never
    imports ``core.precision`` (the planner imports this module for its
    proxy-error loop).

    ``fuse`` (plan field) turns on the unified-datapath fusion; fusion
    implies kernel routing at the fused sites.

    A compiled ``KernelSchedule`` (duck-typed on ``fuse_decision``) is
    also accepted: its embedded plan drives per-site levels exactly as
    before, but fusion decisions and kernel tiles are *read from the
    schedule* instead of re-derived inline.  A schedule compiled for
    another backend (the reference's ``interpret`` or ``tpu``) is refused:
    its tiles are TPU tilings."""

    def __init__(self, policy):
        self._schedule = None
        if hasattr(policy, "fuse_decision"):  # compiled KernelSchedule
            policy.check_servable()
            self._schedule = policy
            policy = policy.plan
        if hasattr(policy, "policy_for"):  # PrecisionPlan
            self._plan = policy
            self.method = policy.method
            self.fuse = bool(getattr(policy, "fuse", False))
            self.use_kernel = bool(getattr(policy, "use_kernel", False)) or self.fuse
        elif isinstance(policy, QuantPolicy):
            self._plan = None
            self._policy = policy
            self.method = policy.method
            self.fuse = False
            self.use_kernel = False
        else:
            raise TypeError(
                f"policy must be a QuantPolicy or PrecisionPlan, got {type(policy)!r}"
            )

    @property
    def use_wht(self) -> bool:
        return self.method in _USE_WHT_METHODS

    def at(self, site: str) -> Optional[QuantPolicy]:
        """The site's policy; None means bf16 passthrough."""
        if self._plan is None:
            return self._policy
        return self._plan.policy_for(site)

    def tiles_at(self, site: str) -> Optional[tuple]:
        """Compiled kernel launch tiles for a site (hashable tuple), or
        None for the kernel's own launch tiles."""
        if self._schedule is None:
            return None
        return self._schedule.tiles_for(site)

    def fuse_decision(self, group: str):
        """None -> no schedule, decide fusion inline; else a
        ``(fuse: bool, group_entry)`` pair read from the schedule."""
        if self._schedule is None:
            return None
        return self._schedule.fuse_decision(group)


def _vmapped(fn, n_lead: int):
    """``fn`` over ``n_lead`` stacked leading axes (scan groups, experts) of
    its tensor arguments: the reference's ``vmap``, here one call per slice
    with the results stacked.  On the ``meta`` device (the compiler's
    abstract walk) every slice gives the same shapes and static fields, so
    one call stands for all."""
    if n_lead == 0:
        return fn
    inner = _vmapped(fn, n_lead - 1)

    def go(*arrs):
        n = arrs[0].shape[0]
        if arrs[0].device.type == "meta":
            return tree_stack([inner(*(a[0] for a in arrs))] * n)
        return tree_stack([inner(*(a[i] for a in arrs)) for i in range(n)])

    return go


def _prep(w: torch.Tensor, pol: _Resolver, site: str, lead: int = 1, **kw):
    """Per-site prepare (quantized or bf16-fused) of a weight with ``lead``
    stacked leading axes ([K, N], [G, K, N], or [G, E, K, N] for a MoE
    layer's experts).  Tensor kwargs (gamma/beta/bias/out_scale) carry the
    same leading axes; None kwargs are passed through."""
    site_policy = pol.at(site)
    tiles = pol.tiles_at(site)
    arr_keys = [k for k in ("gamma", "beta", "bias", "out_scale") if kw.get(k) is not None]
    static_kw = {k: v for k, v in kw.items() if k not in arr_keys}

    def go(w_, *arrs):
        return _prepare_site(w_, pol, site_policy, tiles=tiles, site=site, **static_kw,
                             **dict(zip(arr_keys, arrs)))

    return _vmapped(go, lead)(w, *[kw[k] for k in arr_keys])


def _prepare_site(w, pol: _Resolver, site_policy, *, out_scale=None, tiles=None, site=None,
                  **kw):
    if out_scale is not None:
        w = w * out_scale[None, :]
        if kw.get("bias") is not None:
            kw["bias"] = kw["bias"] * out_scale
    if site_policy is None:  # bf16 passthrough site
        return prepare_linear_fp(w, use_wht=pol.use_wht, **kw)
    return prepare_linear(w, site_policy, use_kernel=pol.use_kernel, tiles=tiles, site=site,
                          **kw)


def _fold_fp(w, gamma=None, beta=None, bias=None, rotate_in=False):
    """Fold γ/β/H into a full-precision consumer (the heads, a MoE router),
    which takes the rotated, γ-less norm output."""
    w = w.to(torch.float32)
    if bias is None:
        b = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    else:
        b = bias.to(torch.float32)
    has_b = bias is not None
    if beta is not None:
        b = b + beta.to(torch.float32) @ w
        has_b = True
    if gamma is not None:
        w = w * gamma.to(torch.float32)[..., :, None]
    if rotate_in:
        blk = transforms.block_size_for(w.shape[-2])
        h = transforms.hadamard_matrix(blk, device=w.device)
        d_in = w.shape[-2]
        lead = tuple(w.shape[:-2])
        w = w.reshape(lead + (d_in // blk, blk, w.shape[-1]))
        w = (h @ w).reshape(lead + (d_in, w.shape[-1]))
    return {"w": w, "b": b if has_b else None}


def _folded(kind: str, dim: int, groups: int | None, device=None) -> FoldedNorm:
    """FoldedNorm whose LN mean-vector ``u`` is stacked for scan groups."""
    fn = make_folded_norm(kind, dim, device=device)
    if fn.u is not None and groups is not None:
        fn = FoldedNorm(kind=fn.kind, u=fn.u.expand(groups, dim).contiguous(), eps=fn.eps)
    return fn


# ---------------------------------------------------------------------------
# unified-datapath fusion (kernels/fused.py descriptors)
# ---------------------------------------------------------------------------


# The reference's TPU kernels keep whole weight panels VMEM-resident, so
# layers whose panels exceed this budget stay on the per-site path there.
# The Hopper kernels tile K and N, so for them it is no residency limit; it
# stays a structural rule at the reference's 8 MiB so that the port builds
# the same fused tree as the reference for every config.
FUSED_PANEL_BUDGET = 8 * 1024 * 1024


def _panel_bytes(p: QuantLinear, groups) -> int:
    """Stored bytes of one layer's weight panel (int8/uint8 = 1 B/elem;
    stacked scan groups are sliced to one group per launch)."""
    return p.qw.values.numel() // (groups or 1)


def _same_mode(parts) -> bool:
    """Sites that can share one kernel launch: all quantized, same
    activation/weight bits, same packing and online-op flags."""
    f = parts[0]
    return all(
        isinstance(p, QuantLinear)
        and p.a_bits == f.a_bits
        and p.qw.bits == f.qw.bits
        and p.qw.packed == f.qw.packed
        and p.idct == f.idct
        and p.dct_block == f.dct_block
        and p.rotate_input == f.rotate_input
        for p in parts
    )


def _zeros_bias(p: QuantLinear) -> torch.Tensor:
    v = p.qw.values
    return torch.zeros(tuple(v.shape[:-2]) + (v.shape[-1],), dtype=torch.float32, device=v.device)


def _concat_sites(parts, *, prologue=None, norm_u=None, tiles=None) -> QuantLinear:
    """One QuantLinear over the output-concat of separately *prepared*
    sites (Q/K/V): they consume the same input, so the per-token
    quantization runs once and the matmuls become one launch.  Each site's
    weights, scales and bias were prepared independently and every output
    width is DCT-block aligned, so the concatenated site computes the same
    numbers as the per-site flow."""
    f = parts[0]
    qw = QTensor(
        values=torch.cat([p.qw.values for p in parts], dim=-1),
        scale=torch.cat([p.qw.scale for p in parts], dim=-1),
        bits=f.qw.bits,
        packed=f.qw.packed,
        pack_axis=f.qw.pack_axis,
    )
    bias = None
    if any(p.bias is not None for p in parts):
        bias = torch.cat([p.bias if p.bias is not None else _zeros_bias(p) for p in parts], dim=-1)
    # merged quant-health attribution: "….attn.wq" -> "….attn.wqkv"
    site = f.site.rsplit(".", 1)[0] + ".wqkv" if f.site else None
    return dataclasses.replace(f, qw=qw, bias=bias, use_kernel=True, prologue=prologue,
                               epilogue=Epilogue(), norm_u=norm_u, tiles=tiles, site=site)


def _norm_u_for(kind: str, dim: int, groups: int | None, device=None):
    """LayerNorm mean-recovery vector for a fused norm prologue (stacked
    for scan groups); None for RMSNorm."""
    u = make_folded_norm(kind, dim, device=device).u
    if u is not None and groups is not None:
        u = u.expand(groups, dim).contiguous()
    return u


def _fuse_qkv(mx: dict, mn_kind: str, d_model: int, groups, rotated: bool, device=None,
              decision=None) -> dict:
    """Merge prepared wq/wk/wv into one ``wqkv`` site with a norm→quantize
    prologue, and move wo's IDCT/bias epilogue in-kernel.

    ``decision`` is None for the inline eligibility checks, or the
    resolver's ``(fuse, group_entry)`` pair when a compiled schedule
    already settled the question (the entry carries the ``wo`` epilogue
    flag and the fused launch's tiles)."""
    parts = [mx["wq"], mx["wk"], mx["wv"]]
    tiles = None
    if decision is not None:
        fuse, entry = decision
        if not fuse:
            return mx
        wo_epi = entry.wo_epilogue
        tiles = entry.tiles
    else:
        if not _same_mode(parts):
            return mx  # mixed-precision Q/K/V (or bf16 islands): keep per-site
        if sum(_panel_bytes(p, groups) for p in parts) > FUSED_PANEL_BUDGET:
            return mx
        wo_epi = (isinstance(mx["wo"], QuantLinear)
                  and _panel_bytes(mx["wo"], groups) <= FUSED_PANEL_BUDGET)
    mx["wqkv"] = _concat_sites(
        parts,
        prologue=Prologue(norm=mn_kind) if rotated else None,
        norm_u=_norm_u_for(mn_kind, d_model, groups, device) if rotated else None,
        tiles=tiles,
    )
    for name in ("wq", "wk", "wv"):
        del mx[name]
    if wo_epi:
        mx["wo"] = dataclasses.replace(mx["wo"], use_kernel=True, epilogue=Epilogue())
    return mx


def _fuse_ffn(f: dict, act: str, fn_kind: str, d_model: int, groups, rotated: bool, device=None,
              decision=None):
    """Prepared dense-FFN dict -> :class:`FusedFFN` (one launch per layer)
    when every member site is quantized compatibly; else unchanged.
    ``decision`` as in :func:`_fuse_qkv`."""
    gate, up, down = f.get("w_gate"), f.get("w_up"), f.get("w_down")
    parts = [p for p in (gate, up, down) if p is not None]
    if decision is not None:
        if not decision[0]:
            return f
    else:
        if not all(isinstance(p, QuantLinear) for p in parts):
            return f
        if gate is not None and not _same_mode([gate, up]):
            return f  # gate/up share one quantized input: bits must agree
        if up.dct_block != down.dct_block:
            return f
        if sum(_panel_bytes(p, groups) for p in parts) > FUSED_PANEL_BUDGET:
            return f
    return FusedFFN(
        w_up=up,
        w_down=down,
        w_gate=gate,
        norm_u=_norm_u_for(fn_kind, d_model, groups, device) if rotated else None,
        act=("silu" if act == "swiglu" else "gelu") if gate is not None else "gelu",
        norm=fn_kind if rotated else None,
    )


def quantize_vggt(cfg: ModelConfig, params: dict, policy) -> dict:
    """Quantize the VGGT tree (``models/vggt.py``) with a uniform
    ``QuantPolicy``, a per-site ``PrecisionPlan`` or a compiled
    ``KernelSchedule``: rotated stream via the
    patch projection + rotated special tokens; AA blocks quantized per
    site with LayerScale folded; heads stay fp with the final-norm fold."""
    pol = _Resolver(policy)
    rotated = pol.use_wht
    q = dict(params)
    if rotated:
        pp = params["patch_proj"]
        q["patch_proj"] = {
            "w": rotate_cols(pp["w"].to(torch.float32)),
            "b": rotate_cols(pp["b"][None, :].to(torch.float32))[0]
            if pp.get("b") is not None else None,
        }
        q["special_tokens"] = rotate_cols(params["special_tokens"].to(torch.float32))

    def quant_block(bp, pfx):
        an: Norm = bp["attn_norm"]
        fn: Norm = bp["ffn_norm"]
        g1, b1 = (an.g, an.b) if rotated else (None, None)
        g2, b2 = (fn.g, fn.b) if rotated else (None, None)
        common = dict(rotate_in_offline=rotated, rotate_input_online=not rotated)
        nb = dict(bp)
        groups = int(an.g.shape[0])
        dev = an.g.device
        if rotated:
            nb["attn_norm"] = _folded("ln", cfg.d_model, groups, dev)
            nb["ffn_norm"] = _folded("ln", cfg.d_model, groups, dev)
        at = dict(bp["attn"])
        dh = cfg.head_dim
        for name in ("wq", "wk"):
            at[name] = _prep(bp["attn"][name]["w"], pol, f"{pfx}.attn.{name}",
                             gamma=g1, beta=b1, bias=bp["attn"][name].get("b"), **common)
        at["wv"] = _prep(bp["attn"]["wv"]["w"], pol, f"{pfx}.attn.wv",
                         gamma=g1, beta=b1, bias=bp["attn"]["wv"].get("b"),
                         head_rot_out=(cfg.n_kv_heads, dh), **common)
        at["wo"] = _prep(bp["attn"]["wo"]["w"], pol, f"{pfx}.attn.wo",
                         bias=bp["attn"]["wo"].get("b"), out_scale=bp.get("ls1"),
                         head_rot_in=(cfg.n_heads, dh), rotate_out_offline=rotated)
        if pol.fuse:
            at = _fuse_qkv(at, an.kind, cfg.d_model, groups, rotated, dev,
                           decision=pol.fuse_decision(f"{pfx}.attn.wqkv"))
        nb["attn"] = at
        ff = dict(bp["ffn"])
        for name in ("w_gate", "w_up"):
            if name in bp["ffn"]:
                ff[name] = _prep(bp["ffn"][name]["w"], pol, f"{pfx}.ffn.{name}",
                                 gamma=g2, beta=b2, bias=bp["ffn"][name].get("b"), **common)
        ff["w_down"] = _prep(bp["ffn"]["w_down"]["w"], pol, f"{pfx}.ffn.w_down",
                             bias=bp["ffn"]["w_down"].get("b"), out_scale=bp.get("ls2"),
                             rotate_input_online=True, rotate_out_offline=rotated)
        if pol.fuse:
            ff = _fuse_ffn(ff, cfg.act, fn.kind, cfg.d_model, groups, rotated, dev,
                           decision=pol.fuse_decision(f"{pfx}.ffn"))
        nb["ffn"] = ff
        nb.pop("ls1", None)
        nb.pop("ls2", None)
        return nb

    blocks = dict(params["blocks"])
    blocks["frame"] = quant_block(params["blocks"]["frame"], "frame")
    blocks["global"] = quant_block(params["blocks"]["global"], "global")
    q["blocks"] = blocks

    fn: Norm = params["final_norm"]
    if rotated:
        q["final_norm"] = make_folded_norm("ln", cfg.d_model, device=fn.g.device)
        for head in ("camera_head", "dpt_head"):
            h = dict(params[head])
            h["fc1"] = _fold_fp(params[head]["fc1"]["w"], gamma=fn.g, beta=fn.b,
                                bias=params[head]["fc1"].get("b"), rotate_in=True)
            q[head] = h
    return q


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


def quantize_lm(cfg: ModelConfig, params: dict, policy) -> dict:
    """Quantize an ``models/lm.py`` parameter tree with a uniform
    ``QuantPolicy``, a per-site ``PrecisionPlan`` or a compiled
    ``KernelSchedule``.  Returns a new tree; the forward code is unchanged
    (dispatch happens on leaf types).  GQA, MLA and Mamba layers with dense
    or MoE FFNs, and rwkv layers.  An rwkv stack keeps an unrotated stream
    (its token shift and decay LoRA read the stream in the clear), so every
    rwkv projection takes the online WHT."""
    pol = _Resolver(policy)
    rotated = pol.use_wht and "rwkv" not in cfg.pattern
    q = dict(params)

    # ---- stream entry: rotate the embedding / frontend output ----
    if rotated:
        q["embed"] = {"w": rotate_cols(params["embed"]["w"].to(torch.float32))}
        if cfg.embed_inputs and "in_proj" in params:
            ip = params["in_proj"]
            q["in_proj"] = {
                "w": rotate_cols(ip["w"].to(torch.float32)),
                "b": rotate_cols(ip["b"][None, :].to(torch.float32))[0]
                if ip.get("b") is not None else None,
            }
        if cfg.pos == "sincos":
            q["pos_rot"] = transforms.blocked_hadamard_matrix(
                cfg.d_model, device=params["embed"]["w"].device)

    # ---- prefix layers (not stacked) + scanned groups (stacked) ----
    q["prefix"] = [
        _quantize_layer(cfg, lp, cfg.pattern[i % len(cfg.pattern)], ffn_kind(cfg, i), pol,
                        rotated, lead=0, pfx=f"prefix.{i}")
        for i, lp in enumerate(params["prefix"])
    ]
    blocks = dict(params["blocks"])
    for j in range(len(cfg.pattern)):
        gi = cfg.first_dense + j
        blocks[f"l{j}"] = _quantize_layer(cfg, params["blocks"][f"l{j}"],
                                          cfg.pattern[gi % len(cfg.pattern)], ffn_kind(cfg, gi),
                                          pol, rotated, lead=1, pfx=f"blocks.l{j}")
    q["blocks"] = blocks

    # ---- final norm + head ----
    fn: Norm = params["final_norm"]
    if rotated:
        q["final_norm"] = make_folded_norm(fn.kind, cfg.d_model, device=fn.g.device)
        if "lm_head" in params:
            q["lm_head"] = _fold_fp(params["lm_head"]["w"], gamma=fn.g, beta=fn.b,
                                    bias=params["lm_head"].get("b"), rotate_in=True)
    return q


def _bcast(x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """[..., d] -> [..., n, d]: one copy of a norm's γ/β per expert."""
    if x is None:
        return None
    return x[..., None, :].expand(tuple(x.shape[:-1]) + (n, x.shape[-1]))


def _quantize_layer(cfg: ModelConfig, lp: dict, kind: str, fk: str, pol: _Resolver,
                    rotated: bool, *, lead: int, pfx: str) -> dict:
    """One layer (``lead`` = 1: stacked over scan groups; 0: a prefix
    layer).  Attention: the GQA sites with the per-head V/O Hadamard pair
    and the LayerScale fold, ``_fuse_qkv``.  Mamba: ``w_in`` absorbs the
    mixer norm, ``w_out`` takes the online WHT on its input; Δ/B/C, the
    conv, ``a_log`` and ``d_skip`` stay full precision.  A dense FFN: the
    one online WHT before ``w_down``, ``_fuse_ffn``; a MoE FFN (``fk``):
    ``_quantize_moe``.  rwkv: ``_quantize_rwkv``."""
    if kind == "rwkv":
        return _quantize_rwkv(lp, pol, lead=lead, pfx=pfx)
    out = dict(lp)
    mn: Norm = lp["mixer_norm"]
    fnm: Norm = lp["ffn_norm"]
    g1, b1 = (mn.g, mn.b) if rotated else (None, None)
    g2, b2 = (fnm.g, fnm.b) if rotated else (None, None)
    groups = int(mn.g.shape[0]) if lead else None
    dev = mn.g.device
    if rotated:
        out["mixer_norm"] = _folded(mn.kind, cfg.d_model, groups, dev)
        out["ffn_norm"] = _folded(fnm.kind, cfg.d_model, groups, dev)
    ls1, ls2 = lp.get("ls1"), lp.get("ls2")
    common = dict(rotate_in_offline=rotated, rotate_input_online=not rotated)

    if kind == "mamba":
        mx = dict(lp["mixer"])
        mx["w_in"] = _prep(lp["mixer"]["w_in"]["w"], pol, f"{pfx}.mixer.w_in", lead,
                           gamma=g1, beta=b1, **common)
        mx["w_out"] = _prep(lp["mixer"]["w_out"]["w"], pol, f"{pfx}.mixer.w_out", lead,
                            rotate_input_online=True, rotate_out_offline=rotated)
    elif cfg.mla:
        mx = _quantize_mla(cfg, lp["mixer"], pol, rotated, g1, b1, ls1, common, groups, dev,
                           lead=lead, pfx=pfx)
    else:
        mx = dict(lp["mixer"])  # qk-norm stays a full-precision island
        dh = cfg.head_dim
        for name in ("wq", "wk"):
            mx[name] = _prep(lp["mixer"][name]["w"], pol, f"{pfx}.mixer.{name}", lead,
                             gamma=g1, beta=b1, bias=lp["mixer"][name].get("b"), **common)
        mx["wv"] = _prep(lp["mixer"]["wv"]["w"], pol, f"{pfx}.mixer.wv", lead,
                         gamma=g1, beta=b1, bias=lp["mixer"]["wv"].get("b"),
                         head_rot_out=(cfg.n_kv_heads, dh), **common)
        mx["wo"] = _prep(lp["mixer"]["wo"]["w"], pol, f"{pfx}.mixer.wo", lead,
                         bias=lp["mixer"]["wo"].get("b"), out_scale=ls1,
                         head_rot_in=(cfg.n_heads, dh), rotate_out_offline=rotated)
        if pol.fuse:
            mx = _fuse_qkv(mx, mn.kind, cfg.d_model, groups, rotated, dev,
                           decision=pol.fuse_decision(f"{pfx}.mixer.wqkv"))
    out["mixer"] = mx
    out.pop("ls1", None)

    if fk == "moe":
        out["ffn"] = _quantize_moe(cfg, lp["ffn"], pol, rotated, g2, b2, common, lead=lead,
                                   pfx=pfx)
        return out
    f = dict(lp["ffn"])
    for name in ("w_gate", "w_up"):
        if name in lp["ffn"]:
            f[name] = _prep(lp["ffn"][name]["w"], pol, f"{pfx}.ffn.{name}", lead,
                            gamma=g2, beta=b2, bias=lp["ffn"][name].get("b"), **common)
    f["w_down"] = _prep(lp["ffn"]["w_down"]["w"], pol, f"{pfx}.ffn.w_down", lead,
                        bias=lp["ffn"]["w_down"].get("b"), out_scale=ls2,
                        rotate_input_online=True, rotate_out_offline=rotated)
    if pol.fuse:
        f = _fuse_ffn(f, cfg.act, fnm.kind, cfg.d_model, groups, rotated, dev,
                      decision=pol.fuse_decision(f"{pfx}.ffn"))
    out["ffn"] = f
    out.pop("ls2", None)
    return out


def _quantize_mla(cfg: ModelConfig, mixer: dict, pol: _Resolver, rotated: bool, g1, b1, ls1,
                  common: dict, groups, dev, *, lead: int, pfx: str) -> dict:
    """The reference's MLA branch: ``wq`` takes the pre-norm fold;
    ``w_kv_down`` rotates only its ``rank`` LoRA columns (so the compressed
    cache lives in the rotated basis) and keeps the rope columns as they
    are, under its own site policy; with the WHT, ``kv_norm`` becomes a
    folded RMS norm whose γ folds into ``w_k_up`` and ``w_v_up``, which take
    their input rotated (offline, never online); ``w_v_up``/``wo`` carry the
    per-head Hadamard pair and ``wo`` the LayerScale fold.  The MLA sites
    are never fused (the reference calls no ``_fuse_qkv`` here)."""
    mx = dict(mixer)
    mx["wq"] = _prep(mixer["wq"]["w"], pol, f"{pfx}.mixer.wq", lead, gamma=g1, beta=b1,
                     bias=mixer["wq"].get("b"), **common)
    rank = cfg.kv_lora_rank
    site = f"{pfx}.mixer.w_kv_down"
    kvdown_policy, tiles = pol.at(site), pol.tiles_at(site)
    norm_keys = [k for k, v in (("gamma", g1), ("beta", b1)) if v is not None]

    def prep_kvdown(w_, *arrs):
        d = dict(zip(norm_keys, arrs))
        lora, rope = w_[:, :rank], w_[:, rank:]
        if pol.use_wht:
            lora = rotate_cols(lora)
        w2 = torch.cat([lora, rope.to(lora.dtype)], dim=1)
        if kvdown_policy is None:
            return prepare_linear_fp(w2, use_wht=pol.use_wht, bias=None, **common, **d)
        # no site= here: the reference's w_kv_down carries no site name
        return prepare_linear(w2, kvdown_policy, bias=None, use_kernel=pol.use_kernel,
                              tiles=tiles, **common, **d)

    mx["w_kv_down"] = _vmapped(prep_kvdown, lead)(mixer["w_kv_down"]["w"],
                                                  *[a for a in (g1, b1) if a is not None])
    gkv = mixer["kv_norm"].g if pol.use_wht else None
    if pol.use_wht:
        mx["kv_norm"] = _folded("rms", rank, groups, dev)
    up = dict(gamma=gkv, rotate_in_offline=pol.use_wht, rotate_input_online=False)
    mx["w_k_up"] = _prep(mixer["w_k_up"]["w"], pol, f"{pfx}.mixer.w_k_up", lead, **up)
    mx["w_v_up"] = _prep(mixer["w_v_up"]["w"], pol, f"{pfx}.mixer.w_v_up", lead, **up,
                         head_rot_out=(cfg.n_heads, cfg.v_head_dim))
    mx["wo"] = _prep(mixer["wo"]["w"], pol, f"{pfx}.mixer.wo", lead,
                     bias=mixer["wo"].get("b"), out_scale=ls1,
                     head_rot_in=(cfg.n_heads, cfg.v_head_dim), rotate_out_offline=rotated)
    return mx


def _quantize_moe(cfg: ModelConfig, ffn: dict, pol: _Resolver, rotated: bool, g2, b2,
                  common: dict, *, lead: int, pfx: str) -> dict:
    """The reference's MoE branch: the router stays full precision and
    absorbs the folded γ/β and the stream rotation; the routed experts are
    prepared per (group, expert), ``w_gate``/``w_up`` like the dense gate/up
    sites and ``w_down`` with the online WHT on its input; the shared
    experts take the dense-site treatment, unfused."""
    f = dict(ffn)
    rt = ffn["router"]
    arrs = {k: v for k, v in (("gamma", g2), ("beta", b2), ("bias", rt.get("b")))
            if v is not None}
    f["router"] = _vmapped(
        lambda w_, *a: _fold_fp(w_, **dict(zip(arrs, a)), rotate_in=rotated), lead,
    )(rt["w"], *arrs.values())
    ex = ffn["experts"]
    nex = dict(ex)
    e = cfg.n_experts
    for name in ("w_gate", "w_up"):
        if name in ex:
            nex[name] = _prep(ex[name], pol, f"{pfx}.ffn.experts.{name}", lead + 1,
                              gamma=_bcast(g2, e), beta=_bcast(b2, e), **common)
    nex["w_down"] = _prep(ex["w_down"], pol, f"{pfx}.ffn.experts.w_down", lead + 1,
                          rotate_input_online=True, rotate_out_offline=rotated)
    f["experts"] = nex
    if "shared" in ffn:
        sh = dict(ffn["shared"])
        for name in ("w_gate", "w_up"):
            if name in ffn["shared"]:
                sh[name] = _prep(ffn["shared"][name]["w"], pol, f"{pfx}.ffn.shared.{name}",
                                 lead, gamma=g2, beta=b2, **common)
        sh["w_down"] = _prep(ffn["shared"]["w_down"]["w"], pol, f"{pfx}.ffn.shared.w_down",
                             lead, rotate_input_online=True, rotate_out_offline=rotated)
        f["shared"] = sh
    return f


def _quantize_rwkv(lp: dict, pol: _Resolver, *, lead: int, pfx: str) -> dict:
    """One rwkv layer: the time-mix ``wr/wk/wv/wg/wo`` and the channel-mix
    ``w_up/w_down``, each with the online WHT on its input; the lerp
    factors, the decay LoRA, the bonus, ``ln_x`` and both pre-norms stay
    full precision."""
    out = dict(lp)
    mx = dict(lp["mixer"])
    for name in ("wr", "wk", "wv", "wg", "wo"):
        mx[name] = _prep(lp["mixer"][name]["w"], pol, f"{pfx}.mixer.{name}", lead,
                         rotate_input_online=True)
    out["mixer"] = mx
    f = dict(lp["ffn"])
    for name in ("w_up", "w_down"):
        f[name] = _prep(lp["ffn"][name]["w"], pol, f"{pfx}.ffn.{name}", lead,
                        rotate_input_online=True)
    out["ffn"] = f
    return out
