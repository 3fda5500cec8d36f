"""Shared layer primitives (port of ``repro/models/layers.py``).

Every linear/norm goes through ``core.versaq.apply_linear``/``apply_norm``
so the same model code runs full precision (plain dict params) and
VersaQ-quantized (``QuantLinear``/``FoldedNorm`` params).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.versaq import Norm, apply_linear, apply_norm
from repro_torch.sharded import routed

__all__ = [
    "dense",
    "norm",
    "init_linear",
    "init_norm",
    "embed",
    "rope_freqs",
    "apply_rope",
    "sincos_positions",
    "gelu",
    "silu",
    "remat",
    "split_dim",
    "constrain",
]

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
    scale: float | None = None,
) -> dict:
    w = torch.randn((d_in, d_out), generator=generator, device=device)
    w = w / math.sqrt(d_in) if scale is None else w * scale
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


@routed
def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped into ``sizes`` (a head split; on a
    sharded path ``parallel.sites.split_dim``)."""
    d = dim % x.ndim
    return x.reshape(*x.shape[:d], *sizes, *x.shape[d + 1:])


def constrain(x: torch.Tensor, sharding) -> torch.Tensor:
    """The forwards' ``act_sharding``: ``x`` redistributed to ``sharding``
    (``parallel.sharding.constrain``), or as it is with None."""
    if sharding is None:
        return x
    from repro_torch.parallel.sharding import constrain as redistribute

    return redistribute(x, sharding)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*, L, head_dim//2] for positions [*, L], in float32
    and in the reference's order: ``1 / theta**(i/dh)``, then the angle
    ``position * inv``.  The cosines and sines of large angles feed the int8
    roundings of the KV cache, so the order is kept, and the power is
    rounded correctly to float32 (taken in float64, then rounded), as the
    reference's float32 power is: torch's float32 ``pow`` is an ulp off at
    some exponents, which moves the angle of position 40,000 by ~2e-6."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    powed = torch.pow(torch.tensor(theta, dtype=torch.float64, device=positions.device),
                      (i / head_dim).to(torch.float64)).to(torch.float32)
    inv = 1.0 / powed
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (first half, second half). x: [..., L, H, dh];
    cos/sin: [..., L, dh//2], broadcast over the head axis."""
    dh = x.shape[-1]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def sincos_positions(length: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Classic transformer sinusoidal position table [length, dim]."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


# matmul outputs a "dots" checkpoint keeps (JAX's ``dots_saveable`` policy)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy):
    """``fn`` activation-checkpointed as the reference's ``jax.checkpoint``
    of a scan body: ``policy`` False/None (keep everything), True (keep
    only the inputs, recompute the rest in the backward) or ``"dots"`` /
    ``"dots_saveable"`` (also keep every matmul's output).  Without grad
    mode there is nothing to keep, and ``fn`` runs as it is."""
    if not policy or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if policy in ("dots", "dots_saveable"):
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif policy is not True:
        raise ValueError(f"remat={policy!r}: expected False, True, 'dots' or 'dots_saveable'")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)
