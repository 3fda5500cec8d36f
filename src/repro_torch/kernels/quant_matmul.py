"""Integer matmul for VersaQ quantized linears: ``y = (xv·wv)·xs·ws``.

Port of ``repro/kernels/quant_matmul.py`` (Pallas ``quant_matmul``, the
paper's reconfigurable INT PE array).  The CUDA kernel lives in
``csrc/quant_matmul.cu``; its source note says how it maps the TPU design
to Hopper and what bounds it.

* W8A8: ``wv`` int8 [K, N].
* W4A8 / W4A4: ``wv`` packed uint8 [K/2, N] (low nibble = K-rows
  ``[0, K/2)``, high nibble = ``[K/2, K)``), unpacked inside the kernel.

:func:`quant_matmul` launches the kernel for CUDA tensors (and counts the
launch in ``kernels.probe``) and runs :func:`quant_matmul_plain` for CPU
tensors.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import unpack_int4
from repro_torch.kernels import _build, probe

__all__ = ["quant_matmul", "quant_matmul_plain", "function_bytes", "LAUNCH_TILES"]

# The tile the kernel launches with (csrc/quant_matmul.cu ``BM``, ``BN``
# and ``Geom::BK``): one block per 128x256 output tile, 64 K bytes of A a
# ring step.  Ragged M and N edges are masked in the kernel.
LAUNCH_TILES = {"bm": 128, "bn": 256, "bk": 64}

_fn = None


def quant_matmul_plain(
    xv: torch.Tensor, xs: torch.Tensor, wv: torch.Tensor, ws: torch.Tensor, *, packed: bool
) -> torch.Tensor:
    """Plain PyTorch version: exact integer accumulate, then scale.

    The products are summed in float64, which holds every int8·int8 sum
    exactly (at W8A8, K=4096, |acc| reaches 66M > 2²⁴, which float32 would
    round), then scaled in the kernel's order ``float(acc) * xs * ws``.
    """
    if packed:
        wv = unpack_int4(wv, axis=0)
    acc = xv.to(torch.float64) @ wv.to(torch.float64)
    return acc.to(torch.float32) * xs.reshape(-1, 1) * ws.reshape(1, -1)


def function_bytes(m: int, k: int, n: int, *, packed: bool) -> int:
    """Bytes of the function: x, its scales, the stored weight, its scales
    and y, each moved once (what a launch records in ``kernels.probe``)."""
    return m * k + 4 * m + (k // 2 if packed else k) * n + 4 * n + 4 * m * n


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("quant_matmul").vq_quant_matmul
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"quant_matmul: {what}")


def quant_matmul(
    xv: torch.Tensor, xs: torch.Tensor, wv: torch.Tensor, ws: torch.Tensor, *, packed: bool
) -> torch.Tensor:
    """y[M,N] f32 = (xv·wv) * xs * ws.

    xv [M,K] int8, xs [M,1] (or [M]) f32, ws [1,N] (or [N]) f32;
    wv [K,N] int8, or [K//2,N] uint8 when ``packed``.
    """
    if xv.device.type == "cpu":
        return quant_matmul_plain(xv, xs, wv, ws, packed=packed)
    if xv.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {xv.device}")
    m, k = xv.shape
    n = wv.shape[-1]
    _check(xv.dtype == torch.int8, f"xv must be int8, got {xv.dtype}")
    _check(wv.dtype == (torch.uint8 if packed else torch.int8), f"wv dtype {wv.dtype}")
    _check(wv.shape[0] * (2 if packed else 1) == k, f"wv {tuple(wv.shape)} vs K={k}")
    _check(k % (32 if packed else 16) == 0, f"K={k} must be a multiple of {32 if packed else 16}")
    _check(not packed or k < 1 << 17, f"K={k}: W4 needs K < 2^17 (the kernel sums 16 w in int32)")
    _check(n % 4 == 0, f"N={n} must be a multiple of 4")
    _check(xs.numel() == m and ws.numel() == n, "scale shapes")
    _check(xs.dtype == torch.float32 and ws.dtype == torch.float32, "scales must be float32")
    tensors = (xv, xs, wv, ws)
    for t in tensors:
        _check(t.device == xv.device, "all operands on one device")
        _check(t.is_contiguous(), "operands must be contiguous")
    _check(xv.data_ptr() % 16 == 0 and wv.data_ptr() % 4 == 0, "operand alignment")
    out = torch.empty((m, n), dtype=torch.float32, device=xv.device)
    if m == 0:
        return out
    with torch.cuda.device(xv.device):
        rc = _kernel()(
            xv.data_ptr(), xs.data_ptr(), wv.data_ptr(), ws.data_ptr(), out.data_ptr(),
            m, n, k, int(packed), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: cudaError {rc}")
    probe.record("quant_matmul", nbytes=function_bytes(m, k, n, packed=packed))
    return out
