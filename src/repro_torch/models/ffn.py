"""Dense feed-forward mixers (port of ``repro/models/ffn.py``: dense GLU and
GELU FFNs, and the unified datapath's ``FusedFFN``; the MoE path is not
ported)."""
from __future__ import annotations

import torch

from repro_torch.core.versaq import FusedFFN, apply_ffn, carries_norm
from repro_torch.models import layers as L

__all__ = ["init_dense_ffn", "dense_ffn", "carries_norm"]


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
