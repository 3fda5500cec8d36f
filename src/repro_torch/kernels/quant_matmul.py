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

:func:`quant_matmul_batched` is the reference's ``jax.vmap`` over the same
``pallas_call`` (a MoE layer's routed experts, ``models/ffn.py``): one
launch over B stacked problems, the kernel's grid taking one more axis;
problem ``b`` multiplies by expert ``b % E`` of E stacked weights, so the
dispatch blocks of a layer share its experts' weights without copies.  It
counts as ``quant_matmul_batched`` in the probe.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import unpack_int4
from repro_torch.kernels import _build, probe
from repro_torch.sharded import refuse_dtensor

__all__ = ["quant_matmul", "quant_matmul_plain", "quant_matmul_batched",
           "quant_matmul_batched_plain", "function_bytes", "batched_function_bytes",
           "LAUNCH_TILES"]

# The tile the kernel launches with (csrc/quant_matmul.cu ``BM``, ``BN``
# and ``Geom::BK``): one block per 128x256 output tile, 64 K bytes of A a
# ring step.  Ragged M and N edges are masked in the kernel.
LAUNCH_TILES = {"bm": 128, "bn": 256, "bk": 64}

_fn = None
_fn_batched = None


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


def batched_function_bytes(b: int, e: int, m: int, k: int, n: int, *, packed: bool) -> int:
    """Bytes of the batched function: B problems' x, scales and y, and the E
    stacked weights and their scales, each moved once."""
    return b * (m * k + 4 * m + 4 * m * n) + e * ((k // 2 if packed else k) * n + 4 * n)


def quant_matmul_batched_plain(
    xv: torch.Tensor, xs: torch.Tensor, wv: torch.Tensor, ws: torch.Tensor, *, packed: bool
) -> torch.Tensor:
    """Plain version of :func:`quant_matmul_batched`: the integer products
    summed exactly in float64, problem ``b`` against weights ``b % E``,
    then scaled in the kernel's order ``float(acc) * xs * ws``."""
    b, m, _ = xv.shape
    e, n = wv.shape[0], wv.shape[-1]
    if packed:
        wv = unpack_int4(wv, axis=1)
    reps = b // e
    acc = torch.bmm(xv.to(torch.float64), wv.to(torch.float64).repeat(reps, 1, 1))
    return (acc.to(torch.float32) * xs.reshape(b, m, 1)
            * ws.reshape(e, 1, n).repeat(reps, 1, 1))


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("quant_matmul").vq_quant_matmul
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _kernel_batched():
    global _fn_batched
    if _fn_batched is None:
        fn = _build.load("quant_matmul").vq_quant_matmul_batched
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn_batched = fn
    return _fn_batched


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"quant_matmul: {what}")


def _check_operands(xv, xs, wv, ws, *, packed: bool, k: int, n: int, rows: int,
                    experts: int) -> None:
    """The checks both launches share: types, K and N, ``rows`` x scales and
    ``experts`` x N weight scales, one device, contiguity, alignment."""
    _check(xv.dtype == torch.int8, f"xv must be int8, got {xv.dtype}")
    _check(wv.dtype == (torch.uint8 if packed else torch.int8), f"wv dtype {wv.dtype}")
    _check(wv.shape[-2] * (2 if packed else 1) == k, f"wv {tuple(wv.shape)} vs K={k}")
    _check(k % (32 if packed else 16) == 0, f"K={k} must be a multiple of {32 if packed else 16}")
    _check(not packed or k < 1 << 17, f"K={k}: W4 needs K < 2^17 (the kernel sums 16 w in int32)")
    _check(n % 4 == 0, f"N={n} must be a multiple of 4")
    _check(xs.numel() == rows and ws.numel() == experts * n, "scale shapes")
    _check(xs.dtype == torch.float32 and ws.dtype == torch.float32, "scales must be float32")
    for t in (xv, xs, wv, ws):
        _check(t.device == xv.device, "all operands on one device")
        _check(t.is_contiguous(), "operands must be contiguous")
    # (a batched launch's every problem then starts 16-byte aligned in x,
    # K % 16, and 4-byte aligned in the weights, N % 4)
    _check(xv.data_ptr() % 16 == 0 and wv.data_ptr() % 4 == 0, "operand alignment")


def _launch(fn, name: str, out: torch.Tensor, xv, xs, wv, ws, *dims, nbytes: int):
    if out.numel() == 0:
        return out
    with torch.cuda.device(xv.device):
        rc = fn(xv.data_ptr(), xs.data_ptr(), wv.data_ptr(), ws.data_ptr(), out.data_ptr(),
                *dims, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    probe.record(name, nbytes=nbytes)
    return out


def quant_matmul(
    xv: torch.Tensor, xs: torch.Tensor, wv: torch.Tensor, ws: torch.Tensor, *, packed: bool
) -> torch.Tensor:
    """y[M,N] f32 = (xv·wv) * xs * ws.

    xv [M,K] int8, xs [M,1] (or [M]) f32, ws [1,N] (or [N]) f32;
    wv [K,N] int8, or [K//2,N] uint8 when ``packed``.
    """
    refuse_dtensor("quant_matmul", xv, xs, wv, ws)
    if xv.device.type == "cpu":
        return quant_matmul_plain(xv, xs, wv, ws, packed=packed)
    if xv.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {xv.device}")
    m, k = xv.shape
    n = wv.shape[-1]
    _check_operands(xv, xs, wv, ws, packed=packed, k=k, n=n, rows=m, experts=1)
    out = torch.empty((m, n), dtype=torch.float32, device=xv.device)
    return _launch(_kernel(), "quant_matmul", out, xv, xs, wv, ws, m, n, k, int(packed),
                   nbytes=function_bytes(m, k, n, packed=packed))


def quant_matmul_batched(
    xv: torch.Tensor, xs: torch.Tensor, wv: torch.Tensor, ws: torch.Tensor, *, packed: bool
) -> torch.Tensor:
    """y[B,M,N] f32, y[b] = (xv[b]·wv[b % E]) * xs[b] * ws[b % E], one launch.

    xv [B,M,K] int8, xs [B,M,1] (or [B,M]) f32; wv [E,K,N] int8, or
    [E,K//2,N] uint8 when ``packed``; ws [E,1,N] (or [E,N]) f32; E divides B.
    """
    refuse_dtensor("quant_matmul_batched", xv, xs, wv, ws)
    if xv.device.type == "cpu":
        return quant_matmul_batched_plain(xv, xs, wv, ws, packed=packed)
    if xv.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {xv.device}")
    _check(xv.ndim == 3 and wv.ndim == 3, f"batched operands xv {tuple(xv.shape)}, "
                                          f"wv {tuple(wv.shape)}")
    b, m, k = xv.shape
    e, n = wv.shape[0], wv.shape[-1]
    _check(e >= 1 and b % e == 0 and b <= 65535,
           f"{b} problems over {e} weights: E must divide B, and B <= 65535")
    _check_operands(xv, xs, wv, ws, packed=packed, k=k, n=n, rows=b * m, experts=e)
    out = torch.empty((b, m, n), dtype=torch.float32, device=xv.device)
    return _launch(_kernel_batched(), "quant_matmul_batched", out, xv, xs, wv, ws, b, e, m, n, k,
                   int(packed), nbytes=batched_function_bytes(b, e, m, k, n, packed=packed))
