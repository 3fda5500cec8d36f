"""Mamba selective-SSM mixer, for the Jamba hybrid (port of
``repro/models/ssm.py``).

A Mamba-1 block: in-projection -> depthwise causal conv -> SiLU -> selective
scan (input-dependent Δ, B, C; diagonal A) -> gate -> out-projection.  The
reference runs the scan as a ``lax.scan`` over time; here it is a loop over
time on the [B, d_inner, d_state] float32 state, in the reference's op order
(discretization inside the step, so no [B, L, d_inner, d_state] tensor is
ever built).  Decode carries the conv window and the SSM state in the cache
(``MambaState``).

The in- and out-projections are VersaQ-quantizable and go through
``layers.dense``; Δ/B/C, the conv, A and the skip stay in float, as in the
reference.  The mixer is a pure function: it returns the new state, and
``models/lm.py`` writes it into the decode cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharded import routed

__all__ = ["MambaState", "init_mamba", "mamba_mixer", "init_mamba_state"]


class MambaState(NamedTuple):
    """Recurrent decode state of one Mamba layer (stacked scan groups carry a
    leading group axis: [G, B, ...])."""

    conv: torch.Tensor  # [B, d_conv - 1, d_inner] the last inputs of the conv
    ssm: torch.Tensor  # [B, d_inner, d_state]


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = _dt_rank(cfg)
    kw = dict(dtype=dtype, device=device)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device).repeat(di, 1)
    return {
        "w_in": L.init_linear(generator, d, 2 * di, **kw),  # x and the gate z
        "conv_w": (torch.randn((dc, di), generator=generator, device=device)
                   / math.sqrt(dc)).to(dtype),
        "conv_b": torch.zeros((di,), **kw),
        "w_xproj": L.init_linear(generator, di, dt_rank + 2 * ds, **kw),
        "w_dt": L.init_linear(generator, dt_rank, di, bias=True, **kw),
        "a_log": torch.log(a).to(dtype),
        "d_skip": torch.ones((di,), **kw),
        "w_out": L.init_linear(generator, di, d, **kw),
    }


@routed
def _selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
                    c_in: torch.Tensor, d_skip: torch.Tensor,
                    init_state: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over time, in float32: u/dt [B, L, di], a (the
    ``a_log`` parameter) [di, ds], b/c [B, L, ds], the skip [di], the state
    [B, di, ds] (zeros when None).  Returns (y [B, L, di], the state after
    the last token).  One loop step per token (the reference's
    ``lax.scan``), discretizing ``exp(Δ·A)`` and ``Δ·B·u`` inside the step.
    On a sharded path ``parallel.sites._selective_scan`` runs it on each
    rank's channels."""
    neg_a = -torch.exp(a.to(torch.float32))  # [di, ds]
    bsz, l, di = u.shape
    h = (torch.zeros((bsz, di, a.shape[-1]), dtype=torch.float32, device=u.device)
         if init_state is None else init_state)
    ys = []
    for t in range(l):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * neg_a)  # [B, di, ds]
        h = da * h + (dt_t * u[:, t])[..., None] * b_in[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_in[:, t]))
    return torch.stack(ys, dim=1) + u * d_skip, h


def mamba_mixer(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[MambaState] = None, mode: str = "full"
                ) -> tuple[torch.Tensor, Optional[MambaState]]:
    """x [B, L, d] -> (out [B, L, d], the new state).  With ``state`` the
    conv reads the carried window; without it, zero padding.  The new state
    is returned when a state was passed or ``mode`` is not ``"full"`` (None
    otherwise), as in the reference."""
    b, l, d = x.shape
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = _dt_rank(cfg)

    xz = L.dense(p["w_in"], x)
    u, z = xz[..., :di], xz[..., di:]

    # the depthwise causal conv over time
    if state is not None:
        upad = torch.cat([state.conv.to(u.dtype), u], dim=1)
    else:
        upad = F.pad(u, (0, 0, dc - 1, 0))
    new_conv = upad[:, -(dc - 1):, :]
    wc = p["conv_w"].to(torch.float32)
    uc = sum(upad[:, i:i + l, :].to(torch.float32) * wc[i] for i in range(dc))
    uc = L.silu(uc + p["conv_b"].to(torch.float32))

    proj = L.dense(p["w_xproj"], uc.to(x.dtype))
    dt_in = proj[..., :dt_rank]
    b_in = proj[..., dt_rank:dt_rank + ds].to(torch.float32)
    c_in = proj[..., dt_rank + ds:].to(torch.float32)
    dt = L.dense(p["w_dt"], dt_in).to(torch.float32)
    dt = torch.logaddexp(dt, dt.new_zeros(()))  # softplus, as jax.nn.softplus computes it

    y, h_last = _selective_scan(uc, dt, p["a_log"], b_in, c_in, p["d_skip"].to(torch.float32),
                                state.ssm if state is not None else None)
    y = (y * L.silu(z.to(torch.float32))).to(x.dtype)
    out = L.dense(p["w_out"], y)
    keep = state is not None or mode != "full"
    return out, MambaState(conv=new_conv, ssm=h_last) if keep else None


def init_mamba_state(cfg: ModelConfig, batch: int, n_groups: int, device=None) -> MambaState:
    di = cfg.mamba_expand * cfg.d_model
    kw = dict(dtype=torch.float32, device=device)
    return MambaState(
        conv=torch.zeros((n_groups, batch, cfg.mamba_d_conv - 1, di), **kw),
        ssm=torch.zeros((n_groups, batch, di, cfg.mamba_d_state), **kw),
    )
