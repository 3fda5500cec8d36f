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

Both a uniform ``QuantPolicy`` and a per-site ``PrecisionPlan`` are
accepted.  The reference prepares the stacked scan groups with ``vmap``;
here each group is prepared in a loop and the results are stacked, which
yields the same leaves.  The fused datapath (``fuse=True``) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.versaq import (
    FoldedNorm,
    Norm,
    QuantPolicy,
    make_folded_norm,
    prepare_linear,
    prepare_linear_fp,
    rotate_cols,
)
from repro_torch.core import transforms
from repro_torch.tree import tree_stack

__all__ = ["quantize_vggt"]

_USE_WHT_METHODS = ("quarot", "versaq")


class _Resolver:
    """Uniform ``QuantPolicy`` or per-site ``PrecisionPlan`` behind one
    interface, duck-typed on ``policy_for`` (a plan) so this module never
    imports ``core.precision``."""

    def __init__(self, policy):
        if hasattr(policy, "policy_for"):  # PrecisionPlan
            if getattr(policy, "fuse", False):
                raise NotImplementedError("fused datapath not ported yet")
            self._plan = policy
            self.method = policy.method
            self.use_kernel = bool(getattr(policy, "use_kernel", False))
        elif isinstance(policy, QuantPolicy):
            self._plan = None
            self._policy = policy
            self.method = policy.method
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
        nb["attn"] = at
        ff = dict(bp["ffn"])
        for name in ("w_gate", "w_up"):
            if name in bp["ffn"]:
                ff[name] = _prep(bp["ffn"][name]["w"], pol, f"{pfx}.ffn.{name}",
                                 gamma=g2, beta=b2, bias=bp["ffn"][name].get("b"), **common)
        ff["w_down"] = _prep(bp["ffn"]["w_down"]["w"], pol, f"{pfx}.ffn.w_down",
                             bias=bp["ffn"]["w_down"].get("b"), out_scale=bp.get("ls2"),
                             rotate_input_online=True, rotate_out_offline=rotated)
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
