"""Orthogonal transforms for VersaQ-3D quantization (paper §II-C, §III).

Port of ``repro/core/transforms.py``:

* **WHT** (Walsh-Hadamard) on *activations* for incoherence processing —
  ±1/sqrt(n) entries, so the online transform is a multiplier-free
  butterfly (:func:`fast_wht`).
* **DCT** (orthonormal DCT-II) on *weights*, offline, for structural
  preservation.

Feature dims are not all powers of two, so both transforms are applied
block-diagonally with the largest power-of-two divisor as the block
(capped at 64 for the DCT, HEVC's largest block).  The matrices are built
in float64 numpy and cast once, exactly as the reference builds them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "hadamard_matrix",
    "dct_matrix",
    "block_size_for",
    "blocked_hadamard_matrix",
    "apply_blocked",
    "fast_wht",
]


def _largest_pow2_divisor(n: int) -> int:
    return n & (-n)


def block_size_for(dim: int, cap: int = 4096) -> int:
    """Largest power-of-two block size that divides ``dim`` (≤ cap)."""
    b = _largest_pow2_divisor(dim)
    while b > cap:
        b //= 2
    if b < 2:
        raise ValueError(f"dim {dim} has no power-of-two factor >= 2")
    return b


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Normalized Hadamard matrix H_n (n a power of two), H Hᵀ = I, H = Hᵀ."""
    if n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of two, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / math.sqrt(n)).astype(np.float64)


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _dct_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D (rows = basis), D Dᵀ = I."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float64)


def dct_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(_dct_np(n), dtype=dtype, device=device)


def blocked_hadamard_matrix(dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Block-diagonal Hadamard for an arbitrary dim (dense [dim, dim])."""
    b = block_size_for(dim)
    out = np.kron(np.eye(dim // b), _hadamard_np(b))
    return torch.as_tensor(out, dtype=dtype, device=device)


def fast_wht(x: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """Multiplier-free blocked WHT along the last axis (add/sub butterfly).

    Equivalent to ``x @ blocked_hadamard_matrix(x.shape[-1])`` but runs in
    log2(block) add/sub stages with the reference's exact stage order, so
    results match the JAX butterfly bit for bit on equal inputs.
    """
    dim = x.shape[-1]
    b = block or block_size_for(dim)
    nblk = dim // b
    lead = tuple(x.shape[:-1])
    h = 1
    while h < b:
        x = x.reshape(lead + (nblk, b // (2 * h), 2, h))
        a = x[..., 0, :]
        c = x[..., 1, :]
        x = torch.stack([a + c, a - c], dim=-2)
        h *= 2
    x = x.reshape(lead + (nblk, b))
    x = x * torch.tensor(1.0 / math.sqrt(b), dtype=x.dtype, device=x.device)
    return x.reshape(lead + (dim,))


def apply_blocked(x: torch.Tensor, mat: torch.Tensor, block: int) -> torch.Tensor:
    """y = x @ M where M is block-diagonal with [block, block] blocks.

    ``mat`` is the [block, block] block; the dense [dim, dim] matrix is
    never materialized.
    """
    dim = x.shape[-1]
    if dim % block:
        raise ValueError(f"dim {dim} is not a multiple of block {block}")
    lead = tuple(x.shape[:-1])
    y = x.reshape(lead + (dim // block, block)) @ mat.to(x.dtype)
    return y.reshape(lead + (dim,))
