"""Blocked Walsh-Hadamard transform (online rotation) — port of
``repro/kernels/wht.py``.

The accelerator's "±1 WHT mode" (§IV-B): the Hadamard matrix is never
stored.  The TPU kernel ran the factor across the 128-wide groups as an
add/sub butterfly and the 128-wide factor as one MXU dot; the CUDA kernel
(``csrc/wht.cu`` on ``csrc/rows_async.cuh``: rows in registers, fed by a
ring of bulk copies) runs both as butterflies, bit-identical to the fused
FFN's hidden rotation (``csrc/fused_rows.cuh``).  :func:`wht`
launches it for CUDA tensors (and counts the launch in ``kernels.probe``)
and runs :func:`wht_plain`, the Pallas kernel body op for op, for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import transforms
from repro_torch.kernels import _build, probe
from repro_torch.kernels.fused import ROW_WARPS, _blocks_per_sm, grid_for, wht_rows
from repro_torch.sharded import refuse_dtensor

__all__ = ["wht", "wht_plain"]


def wht_plain(x: torch.Tensor, *, block: int | None = None) -> torch.Tensor:
    """Plain version: f32 butterfly across groups, dot with ``H_128``,
    ``1/sqrt(g)``; the result in ``x.dtype``."""
    block = block or transforms.block_size_for(x.shape[-1])
    return wht_rows(x.to(torch.float32), block).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("wht").vq_wht
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def wht(x: torch.Tensor, *, block: int | None = None) -> torch.Tensor:
    """Blocked WHT along the last axis of a 2-D f32 array [R, d]; ``block``
    defaults to ``block_size_for(d)``."""
    refuse_dtensor("wht", x)
    if x.device.type in ("cpu", "meta"):  # meta: the dry run's shapes
        return wht_plain(x, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"wht: unsupported device {x.device}")
    r, d = x.shape
    block = block or transforms.block_size_for(d)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("wht: x must be contiguous, 16-byte aligned float32")
    if d % 4 or block < 2 or block & (block - 1) or d % block:
        raise ValueError(f"wht: d={d} must be a multiple of 4 and of the power-of-two "
                         f"block {block}")
    y = torch.empty_like(x)
    if r == 0:
        return y
    grid = grid_for(x.device, -(-r // ROW_WARPS), _blocks_per_sm("wht", x.device, d))
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), y.data_ptr(), r, d, block, grid,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wht kernel launch failed: cudaError {rc}")
    probe.record("wht", nbytes=8 * r * d)  # f32 x read once, y written once
    return y
