"""RWKV-6 ("Finch") mixer: attention-free, data-dependent decay (port of
``repro/models/rwkv.py``).

The time-mix carries a multi-head matrix-valued WKV state with a per-token,
per-channel decay produced by a LoRA on the token-shifted input; the
channel-mix is a squared-ReLU FFN with token shift.  The reference runs the
recurrence as a ``lax.scan`` over time; here it is a loop over time on the
[B, H, dh, dh] float32 state, in the reference's op order (the two
``einsum``s, the ``exp(-exp(·))`` decay in float32, ``ln_x`` before the
gate).

All projections (r/k/v/g/o and the channel-mix up/down) are VersaQ-
quantizable and go through ``layers.dense``; the decay LoRA and the
recurrence stay in float.  Both mixers are pure functions: they return the
new state pieces, and ``models/lm.py`` writes them into the decode cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = [
    "RWKVState",
    "DECAY_LORA",
    "init_rwkv_time",
    "init_rwkv_channel",
    "rwkv_time_mix",
    "rwkv_channel_mix",
    "wkv_recurrence",
    "init_rwkv_state",
]


class RWKVState(NamedTuple):
    """Recurrent decode state of one rwkv layer (stacked scan groups carry a
    leading group axis: [G, B, ...])."""

    tshift: torch.Tensor  # [B, 1, d] last token (time-mix)
    cshift: torch.Tensor  # [B, 1, d] last token (channel-mix)
    wkv: torch.Tensor  # [B, H, dh, dh]


DECAY_LORA = 64


def init_rwkv_time(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                   device=None) -> dict:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        # lerp factors r, k, v, g, w
        "mu": (torch.rand((5, d), generator=generator, device=device) * 0.1).to(dtype),
        "wr": L.init_linear(generator, d, d, **kw),
        "wk": L.init_linear(generator, d, d, **kw),
        "wv": L.init_linear(generator, d, d, **kw),
        "wg": L.init_linear(generator, d, d, **kw),
        "wo": L.init_linear(generator, d, d, **kw),
        "w_decay_a": L.init_linear(generator, d, DECAY_LORA, **kw),
        "w_decay_b": L.init_linear(generator, DECAY_LORA, d, scale=0.01 / math.sqrt(DECAY_LORA),
                                   **kw),
        "decay_base": torch.full((d,), -6.0, **kw),
        "bonus": torch.full((d // cfg.rwkv_head_dim, cfg.rwkv_head_dim), 0.5, **kw),
        "ln_x": L.init_norm(d, kind="ln", bias=True, **kw),
    }


def init_rwkv_channel(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                      device=None) -> dict:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "mu": (torch.rand((2, d), generator=generator, device=device) * 0.1).to(dtype),
        "w_up": L.init_linear(generator, d, cfg.d_ff, **kw),
        "w_down": L.init_linear(generator, cfg.d_ff, d, **kw),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1}, with a zero or the carried-in token first."""
    if prev is None:
        return torch.nn.functional.pad(x[:, :-1, :], (0, 0, 1, 0))
    return torch.cat([prev, x[:, :-1, :]], dim=1)


def wkv_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence over time, in float32: r/k/v/w [B, L, H, dh], the
    bonus u [H, dh], the state s [B, H, dh, dh].  Returns (y [B, L, H, dh],
    the state after the last token).  One loop step per token (the
    reference's ``lax.scan``)."""
    u = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  state: Optional[RWKVState] = None, mode: str = "full"):
    """x [B, L, d] -> (out [B, L, d], wkv state after the last token
    [B, H, dh, dh] f32, new token shift [B, 1, d]).  ``mode`` is accepted
    for the reference's signature; every mode runs the same recurrence."""
    b, l, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    prev = state.tshift.to(x.dtype) if state is not None else None
    xs = _token_shift(x, prev)
    mu = p["mu"].to(torch.float32)
    xf, xsf = x.to(torch.float32), xs.to(torch.float32)

    def lerp(i):
        return (xf + mu[i] * (xsf - xf)).to(x.dtype)

    r = L.dense(p["wr"], lerp(0)).reshape(b, l, nh, hd)
    k = L.dense(p["wk"], lerp(1)).reshape(b, l, nh, hd)
    v = L.dense(p["wv"], lerp(2)).reshape(b, l, nh, hd)
    g = L.silu(L.dense(p["wg"], lerp(3)).to(torch.float32))
    # data-dependent decay (LoRA), per token per channel
    dw = L.dense(p["w_decay_b"],
                 torch.tanh(L.dense(p["w_decay_a"], lerp(4)).to(torch.float32)).to(x.dtype))
    w = torch.exp(-torch.exp(p["decay_base"].to(torch.float32) + dw.to(torch.float32)))
    w = w.reshape(b, l, nh, hd)
    s0 = (state.wkv.to(torch.float32) if state is not None
          else torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device))
    y, s = wkv_recurrence(r.to(torch.float32), k.to(torch.float32), v.to(torch.float32), w,
                          p["bonus"].to(torch.float32), s0)
    y = y.reshape(b, l, d)
    y = L.norm(p["ln_x"], y.to(x.dtype))  # group-norm-ish output norm
    out = L.dense(p["wo"], (y.to(torch.float32) * g).to(x.dtype))
    return out, s, x[:, -1:, :]


def rwkv_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     prev: Optional[torch.Tensor] = None):
    """x [B, L, d] -> (out [B, L, d], new token shift [B, 1, d])."""
    xs = _token_shift(x, prev.to(x.dtype) if prev is not None else None)
    mu = p["mu"].to(torch.float32)
    xf, xsf = x.to(torch.float32), xs.to(torch.float32)
    xk = (xf + mu[0] * (xsf - xf)).to(x.dtype)
    h = L.dense(p["w_up"], xk)
    h = torch.square(torch.relu(h.to(torch.float32))).to(x.dtype)
    return L.dense(p["w_down"], h), x[:, -1:, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, n_groups: int, device=None) -> RWKVState:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    kw = dict(dtype=torch.float32, device=device)
    return RWKVState(
        tshift=torch.zeros((n_groups, batch, 1, d), **kw),
        cshift=torch.zeros((n_groups, batch, 1, d), **kw),
        wkv=torch.zeros((n_groups, batch, nh, hd, hd), **kw),
    )
