"""Whole-model VersaQ quantization of VGGT (the paper's offline pipeline,
Fig. 6) — port of ``repro/core/model_quant.py::quantize_vggt``.

* The **residual stream is rotated once** (H fused on the patch
  projection's output side, special tokens rotated) and stays rotated.
* Every pre-norm becomes a ``FoldedNorm`` with its γ/β folded into every
  consumer; projections are fused per Eq. 7 and quantized per channel.
* V/O projections carry the per-head Hadamard pair; LayerScale folds into
  the output projections; the FFN hidden→down projection keeps the one
  online WHT.
* Heads stay full precision and absorb the final norm.

* With ``PrecisionPlan(fuse=True)`` the unified datapath is built: Q/K/V
  merge into one ``wqkv`` site that absorbs the LayerNorm as its kernel
  prologue, ``wo`` runs its IDCT/bias in the kernel epilogue, and each
  dense FFN becomes one ``FusedFFN`` launch.

Both a uniform ``QuantPolicy`` and a per-site ``PrecisionPlan`` are
accepted (a compiled ``KernelSchedule`` waits for
``core/precision/compiler.py``).  The reference prepares the stacked scan
groups with ``vmap``; here each group is prepared in a loop and the
results are stacked, which yields the same leaves.
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
from repro_torch.tree import tree_stack

__all__ = ["quantize_vggt", "FUSED_PANEL_BUDGET"]

_USE_WHT_METHODS = ("quarot", "versaq")


class _Resolver:
    """Uniform ``QuantPolicy`` or per-site ``PrecisionPlan`` behind one
    interface, duck-typed on ``policy_for`` (a plan) so this module never
    imports ``core.precision``.

    ``fuse`` (plan field) turns on the unified-datapath fusion; fusion
    implies kernel routing at the fused sites."""

    def __init__(self, policy):
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


def _prep(w: torch.Tensor, pol: _Resolver, site: str, **kw):
    """Per-site prepare (quantized or bf16-fused) of a stacked [G, K, N]
    weight, one scan group at a time.  Tensor kwargs (gamma/beta/bias/
    out_scale) carry the same leading group dim."""
    site_policy = pol.at(site)
    per_group = []
    for gi in range(w.shape[0]):
        kg = {k: (v[gi] if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        per_group.append(_prepare_site(w[gi], pol, site_policy, **kg))
    return tree_stack(per_group)


def _prepare_site(w, pol: _Resolver, site_policy, *, out_scale=None, **kw):
    if out_scale is not None:
        w = w * out_scale[None, :]
        if kw.get("bias") is not None:
            kw["bias"] = kw["bias"] * out_scale
    if site_policy is None:  # bf16 passthrough site
        return prepare_linear_fp(w, use_wht=pol.use_wht, **kw)
    return prepare_linear(w, site_policy, use_kernel=pol.use_kernel, **kw)


def _fold_fp(w, gamma=None, beta=None, bias=None, rotate_in=False):
    """Fold γ/β/H into a full-precision consumer (the heads), which takes
    the rotated, γ-less norm output."""
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


def _concat_sites(parts, *, prologue=None, norm_u=None) -> QuantLinear:
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
    return dataclasses.replace(f, qw=qw, bias=bias, use_kernel=True, prologue=prologue,
                               epilogue=Epilogue(), norm_u=norm_u)


def _norm_u_for(kind: str, dim: int, groups: int | None, device=None):
    """LayerNorm mean-recovery vector for a fused norm prologue (stacked
    for scan groups); None for RMSNorm."""
    u = make_folded_norm(kind, dim, device=device).u
    if u is not None and groups is not None:
        u = u.expand(groups, dim).contiguous()
    return u


def _fuse_qkv(mx: dict, mn_kind: str, d_model: int, groups, rotated: bool, device=None) -> dict:
    """Merge prepared wq/wk/wv into one ``wqkv`` site with a norm→quantize
    prologue, and move wo's IDCT/bias epilogue in-kernel (the reference's
    ``decision=None`` path: eligibility is checked inline)."""
    parts = [mx["wq"], mx["wk"], mx["wv"]]
    if not _same_mode(parts):
        return mx  # mixed-precision Q/K/V (or bf16 islands): keep per-site
    if sum(_panel_bytes(p, groups) for p in parts) > FUSED_PANEL_BUDGET:
        return mx
    wo_epi = isinstance(mx["wo"], QuantLinear) and _panel_bytes(mx["wo"], groups) <= FUSED_PANEL_BUDGET
    mx["wqkv"] = _concat_sites(
        parts,
        prologue=Prologue(norm=mn_kind) if rotated else None,
        norm_u=_norm_u_for(mn_kind, d_model, groups, device) if rotated else None,
    )
    for name in ("wq", "wk", "wv"):
        del mx[name]
    if wo_epi:
        mx["wo"] = dataclasses.replace(mx["wo"], use_kernel=True, epilogue=Epilogue())
    return mx


def _fuse_ffn(f: dict, act: str, fn_kind: str, d_model: int, groups, rotated: bool, device=None):
    """Prepared dense-FFN dict -> :class:`FusedFFN` (one launch per layer)
    when every member site is quantized compatibly; else unchanged."""
    gate, up, down = f.get("w_gate"), f.get("w_up"), f.get("w_down")
    parts = [p for p in (gate, up, down) if p is not None]
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
    ``QuantPolicy`` or a per-site ``PrecisionPlan``: rotated stream via the
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
            at = _fuse_qkv(at, an.kind, cfg.d_model, groups, rotated, dev)
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
            ff = _fuse_ffn(ff, cfg.act, fn.kind, cfg.d_model, groups, rotated, dev)
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
