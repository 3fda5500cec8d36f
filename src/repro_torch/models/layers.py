"""Shared layer primitives (port of ``repro/models/layers.py``, in the part
VGGT needs).

Every linear/norm goes through ``core.versaq.apply_linear``/``apply_norm``
so the same model code runs full precision (plain dict params) and
VersaQ-quantized (``QuantLinear``/``FoldedNorm`` params).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.versaq import Norm, apply_linear, apply_norm

__all__ = ["dense", "norm", "init_linear", "init_norm", "gelu", "silu"]

dense = apply_linear
norm = apply_norm


def init_linear(
    generator: torch.Generator,
    d_in: int,
    d_out: int,
    *,
    bias: bool = False,
    dtype=torch.float32,
    device=None,
) -> dict:
    w = torch.randn((d_in, d_out), generator=generator, device=device) / math.sqrt(d_in)
    return {
        "w": w.to(dtype),
        "b": torch.zeros((d_out,), dtype=dtype, device=device) if bias else None,
    }


def init_norm(dim: int, *, kind: str = "rms", bias: bool = False, dtype=torch.float32, device=None):
    return Norm(
        g=torch.ones((dim,), dtype=dtype, device=device),
        b=torch.zeros((dim,), dtype=dtype, device=device) if bias else None,
        kind=kind,
    )


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
