"""Symmetric integer quantization primitives (paper §III, §V-A).

Port of ``repro/core/quantize.py``.  Bit settings follow the paper:
weights W4 (packed two-per-byte), activations A8 or A4, all symmetric
(zero-point-free) so the integer matmul needs only a post-scale.

Three details are pinned to the reference, because each one decides
integer values bit for bit:

* rounding is half-to-even (``torch.round``, like ``jnp.round``);
* values are ``x / scale`` — a true division, not a reciprocal multiply;
* the amax floor is ``1e-8`` before dividing by ``qmax``.

Packed int4 keeps the reference's interleave-free layout: along the pack
axis, rows ``[0, K/2)`` live in the low nibbles and rows ``[K/2, K)`` in
the high nibbles, so a packed K-tile maps to two *contiguous* activation
K-tiles.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "QTensor",
    "int_range",
    "quantize",
    "quantize_per_token",
    "pack_int4",
    "unpack_int4",
    "quantize_weight",
]


def int_range(bits: int) -> tuple[int, int]:
    """Symmetric signed range for a bit width, e.g. 4 -> (-7, 7)."""
    qmax = 2 ** (bits - 1) - 1
    return -qmax, qmax


@dataclasses.dataclass(frozen=True)
class QTensor:
    """A quantized tensor: integer values + broadcastable scale.

    ``values`` is int8 (possibly holding int4-range numbers) or uint8 when
    ``packed`` (two int4 per byte along ``pack_axis``).  Under stacked scan
    groups the values carry a leading group axis and ``pack_axis`` stays
    relative to one group, as in the reference tree: ``shape`` and the
    unpacking helpers are meant for one group's slice.
    """

    values: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    packed: bool = False
    pack_axis: int = 0

    @property
    def shape(self) -> tuple:
        if not self.packed:
            return tuple(self.values.shape)
        s = list(self.values.shape)
        s[self.pack_axis] *= 2
        return tuple(s)

    def unpacked_values(self) -> torch.Tensor:
        return unpack_int4(self.values, self.pack_axis) if self.packed else self.values

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.unpacked_values().to(dtype) * self.scale.to(dtype)


def quantize(x: torch.Tensor, bits: int, axis: int | tuple[int, ...] | None = -1) -> QTensor:
    """Symmetric quantization with scales reduced over ``axis``.

    ``axis=None`` -> per-tensor scale.  Scales keep reduced dims so they
    broadcast against ``values``.
    """
    _, qmax = int_range(bits)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    container = torch.int8 if bits <= 8 else torch.int32
    q = torch.round(x / scale).clamp(-qmax, qmax).to(container)
    return QTensor(values=q, scale=scale.to(torch.float32), bits=bits)


def quantize_per_token(x: torch.Tensor, bits: int) -> QTensor:
    """Dynamic per-token activation quantization (scale over the last dim)."""
    return quantize(x, bits, axis=-1)


def pack_int4(v: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4-range int8 values two-per-uint8 along ``axis``."""
    if v.dtype != torch.int8:
        raise TypeError(f"pack_int4 expects int8 values, got {v.dtype}")
    if v.shape[axis] % 2:
        raise ValueError(f"pack axis {axis} of {tuple(v.shape)} is odd")
    n = v.shape[axis] // 2
    a = v.narrow(axis, 0, n).to(torch.uint8) & 0xF
    b = v.narrow(axis, n, n).to(torch.uint8) & 0xF
    return a | (b << 4)


def unpack_int4(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> int8 values in [-8, 7]."""
    if p.dtype != torch.uint8:
        raise TypeError(f"unpack_int4 expects uint8, got {p.dtype}")
    lo = (p & 0xF).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    # sign-extend 4-bit two's complement
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=axis)


def quantize_weight(w: torch.Tensor, bits: int, pack: bool | None = None) -> QTensor:
    """Per-output-channel weight quantization for a [in, out] matrix.

    ``bits==4`` packs along the *input* dim by default so the kernel can
    unpack contiguous K-tiles.
    """
    q = quantize(w, bits, axis=tuple(range(w.ndim - 1)))  # scale per out channel
    if pack is None:
        pack = bits == 4
    if pack:
        if bits != 4:
            raise ValueError("only 4-bit weights pack")
        vals = pack_int4(q.values, axis=w.ndim - 2)
        return QTensor(values=vals, scale=q.scale, bits=4, packed=True, pack_axis=w.ndim - 2)
    return q
