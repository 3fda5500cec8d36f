"""The VersaQ arithmetic in plain PyTorch: Hadamard and DCT transforms,
symmetric per-token and per-channel quantization, and one quantized
linear site (paper Fig. 5/6).

Integer products are exact: activations and weights are held as
integer-valued float32, and every product sum here stays below 2**24
(int8 x int4 over K <= 8192, int8 x int8 over K <= 1024), so float32
matmuls with TF32 off add them without rounding.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

DCT_BLOCK = 64


def block_of(dim: int, cap: int = 4096) -> int:
    """Largest power of two dividing ``dim``, at most ``cap``."""
    b = dim & -dim
    while b > cap:
        b //= 2
    return b


@functools.lru_cache(maxsize=None)
def _hadamard64(n: int) -> np.ndarray:
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / math.sqrt(n)


@functools.lru_cache(maxsize=None)
def _dct64(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0] /= np.sqrt(2.0)
    return d


def hadamard(n: int, device) -> torch.Tensor:
    """Normalised Sylvester Hadamard matrix H_n (symmetric, orthonormal)."""
    return torch.tensor(_hadamard64(n), dtype=torch.float32, device=device)


def dct(n: int, device) -> torch.Tensor:
    """Orthonormal DCT-II matrix, rows the basis."""
    return torch.tensor(_dct64(n), dtype=torch.float32, device=device)


def wht(x: torch.Tensor, block: int) -> torch.Tensor:
    """x @ blockdiag(H_block) along the last axis, by butterflies."""
    shape = x.shape
    y = x.reshape(-1, shape[-1] // block, block)
    h = 1
    while h < block:
        y = y.reshape(y.shape[0], y.shape[1], block // (2 * h), 2, h)
        y = torch.stack([y[:, :, :, 0] + y[:, :, :, 1], y[:, :, :, 0] - y[:, :, :, 1]], dim=3)
        h *= 2
    return (y.reshape(shape) * (1.0 / math.sqrt(block))).to(torch.float32)


def blocked(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x @ blockdiag(mat) along the last axis."""
    b = mat.shape[0]
    return (x.reshape(*x.shape[:-1], x.shape[-1] // b, b) @ mat).reshape(x.shape)


def rows_times(mat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """blockdiag(mat) @ w over the rows of w [K, N]."""
    b = mat.shape[0]
    return (mat @ w.reshape(w.shape[0] // b, b, w.shape[1])).reshape(w.shape)


def quant_tokens(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization with one scale per row of the last axis:
    integer values (as float32) and the scales; round half to even."""
    qmax = 2 ** (bits - 1) - 1
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax), scale


def quant_channels(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of w [K, N]: values, scales [N]."""
    qmax = 2 ** (bits - 1) - 1
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / qmax
    return torch.round(w / scale).clamp(-qmax, qmax), scale


class Site:
    """One prepared quantized linear: y = IDCT((Q(x) @ W) * s_x * s_w) + b,
    with an optional blocked WHT on x before quantizing."""

    def __init__(self, w, *, bias=None, gamma=None, beta=None, out_scale=None, rotate_in=None,
                 online_wht=None, head_in=None, head_out=None, rotate_out=None, w_bits=4):
        """``w`` [K, N] raw.  ``gamma``/``beta``: the preceding norm folded
        in (beta through the raw weight).  ``out_scale``: LayerScale.
        ``rotate_in``: a Hadamard block on the input side (the input
        arrives rotated, or, with ``online_wht``, is rotated here).
        ``head_in``/``head_out``: (heads, head_dim), a per-head Hadamard on
        that side.  ``rotate_out``: a Hadamard block on the output side."""
        dev = w.device
        w = w.to(torch.float32)
        b = torch.zeros(w.shape[1], device=dev) if bias is None else bias.to(torch.float32)
        if out_scale is not None:
            w = w * out_scale[None, :]
            b = b * out_scale
        if beta is not None:
            b = b + beta.to(torch.float32) @ w
        if gamma is not None:
            w = w * gamma.to(torch.float32)[:, None]
        if head_in is not None:
            h, dh = head_in
            w = rows_times(hadamard(block_of(dh), dev), w)
        if rotate_in is not None:
            w = rows_times(hadamard(rotate_in, dev), w)
        if head_out is not None:
            h, dh = head_out
            hb = hadamard(block_of(dh), dev)
            w = blocked(w, hb)
            b = blocked(b, hb)
        if rotate_out is not None:
            hb = hadamard(rotate_out, dev)
            w = blocked(w, hb)
            b = blocked(b, hb)
        self.idct = w.shape[1] % DCT_BLOCK == 0
        if self.idct:
            w = blocked(w, dct(DCT_BLOCK, dev).T)
        self.w, self.ws = quant_channels(w, w_bits)
        self.b = b
        self.online_wht = online_wht

    def __call__(self, x: torch.Tensor, a_bits: int = 8) -> torch.Tensor:
        if self.online_wht is not None:
            x = wht(x, self.online_wht)
        q, s = quant_tokens(x, a_bits)
        y = (q @ self.w) * s * self.ws
        if self.idct:
            y = blocked(y, dct(DCT_BLOCK, y.device))
        return y + self.b


def ln_rotated(x: torch.Tensor, d: int, block: int, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm statistics of a stream that lives rotated by a blocked
    Hadamard (gamma and beta folded into the consumers): the mean is read
    through u = H^T 1 / d, which is sqrt(block)/d at each block's first
    coordinate and 0 elsewhere."""
    u = torch.zeros(d, device=x.device)
    u[::block] = math.sqrt(block) / d
    mu = (x * u).sum(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu * u * d) * torch.rsqrt(var + eps)


def rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def exact_pv(pq: torch.Tensor, v: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Integer-valued pq [..., Lq, Lk] @ v [..., Lk, dh], summed exactly
    (float32 over 1024-key chunks, float64 across them)."""
    acc = None
    for c0 in range(0, pq.shape[-1], chunk):
        part = (pq[..., c0:c0 + chunk] @ v[..., c0:c0 + chunk, :]).to(torch.float64)
        acc = part if acc is None else acc + part
    return acc.to(torch.float32)
