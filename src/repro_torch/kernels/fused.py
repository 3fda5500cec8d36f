"""Unified-datapath fusion (paper §IV-B, Fig. 7) — port of
``repro/kernels/fused.py``.

The paper's accelerator runs a linear operator and the nonlinear work
around it (norm statistics, activation, rotations, re-quantization) in one
pass through its reconfigurable datapath.  Three CUDA kernels do the same:

* :func:`norm_quant` — **prologue**: folded-norm statistics (``rms``, or
  ``ln`` through the mean-recovery vector ``u``) → blocked WHT → per-token
  A8/A4 quantization; int8 values + f32 scales (``csrc/norm_quant.cu``).
* :func:`fused_matmul` — the integer matmul with that prologue (for f32
  inputs) and the **epilogue** family: dequant → 64-block IDCT → bias →
  GELU/SiLU → blocked WHT → optional per-token requantization
  (``csrc/fused_matmul.cu``).
* :func:`fused_ffn` — the whole (optionally gated) FFN layer in one launch
  (``csrc/fused_ffn.cu``).

The device building blocks are written once, in ``csrc/fused_rows.cuh``.
Each function launches its kernel for CUDA tensors (and counts the launch
in ``kernels.probe``) and runs its plain PyTorch version for CPU tensors.
The plain versions follow the JAX kernel bodies op for op — the WHT is the
group butterfly followed by a dot with ``H_128``, the integer products sum
exactly (through ``quant_matmul_plain``) — so on the CPU they are the
port's parity twin of the Pallas kernels in interpret mode.

Unlike the TPU kernels, nothing is padded: the CUDA kernels mask ragged
row counts themselves, and the weight panels are tiled over K and N rather
than held resident.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import transforms
from repro_torch.core.quantize import quantize_per_token
from repro_torch.kernels import _build, probe
from repro_torch.kernels.quant_matmul import quant_matmul_plain
from repro_torch.sharded import refuse_dtensor

__all__ = [
    "act_rows",
    "fused_matmul",
    "fused_matmul_plain",
    "fused_ffn",
    "fused_ffn_plain",
    "norm_quant",
    "norm_quant_plain",
    "wht_rows",
    "MATMUL_TILES",
    "FFN_TILES",
    "matmul_function_bytes",
    "ffn_function_bytes",
]

LANE = 128
BM = 64  # rows per M tile of fused_matmul (csrc/fused_rows.cuh FT_BM)
FFN_BM = 64  # rows per M tile of fused_ffn (csrc/fused_ffn.cu BM)
BN = 128  # output columns per N tile of both (csrc/fused_rows.cuh FT_BN)
# The tiles the two kernels launch with: a block walks 64-row M tiles and,
# within one, the weight panel in 128-column N tiles.
MATMUL_TILES = {"bm": BM, "bn": BN}
FFN_TILES = {"bm": FFN_BM, "bn": BN}
DCT_BLOCK = 64  # the only IDCT block the CUDA kernels take
ROW_WARPS = 4  # rows a block of the row kernels (norm_quant, wht) holds at once
_NORMS = {None: 0, "rms": 1, "ln": 2}
_ACTS = {"none": 0, "gelu": 1, "silu": 2}


# ---------------------------------------------------------------------------
# plain building blocks (the JAX kernels' in-kernel helpers, op for op)
# ---------------------------------------------------------------------------


def act_rows(y: torch.Tensor, act: str) -> torch.Tensor:
    """none | tanh-GELU (``jax.nn.gelu(approximate=True)``) | SiLU."""
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act == "silu":
        return F.silu(y)
    if act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y


def norm_rows(x: torch.Tensor, kind: str, u: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """FoldedNorm statistics on [r, d] f32 rows (``_norm_rows``)."""
    if kind == "rms":
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + eps)
    d = x.shape[-1]
    u = u.reshape(1, d)
    mu = torch.sum(x * u, dim=-1, keepdim=True)
    sq = torch.mean(x * x, dim=-1, keepdim=True)
    var = sq - mu * mu
    return (x - mu * u * d) * torch.rsqrt(var + eps)


def wht_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Blocked WHT along the last axis of [r, d] (``_wht_rows``): add/sub
    butterfly across the 128-wide groups, one dot with ``H_128``, then
    ``1/sqrt(g)``; a single dot with ``H_block`` for blocks under 128."""
    r, d = x.shape
    nblk = d // block
    h = transforms.hadamard_matrix(min(block, LANE), device=x.device)
    if block >= LANE:
        g = block // LANE
        xv = x.reshape(r, nblk, g, LANE)
        step = 1
        while step < g:
            xv = xv.reshape(r, nblk, g // (2 * step), 2, step, LANE)
            a = xv[:, :, :, 0]
            b = xv[:, :, :, 1]
            xv = torch.stack([a + b, a - b], dim=3)
            step *= 2
        xv = xv.reshape(r, nblk, g, LANE) @ h
        return (xv * (1.0 / math.sqrt(g))).reshape(r, d)
    return (x.reshape(r, nblk, block) @ h).reshape(r, d)


def quant_rows(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric quantization (``_quant_rows``)."""
    q = quantize_per_token(x, bits)
    return q.values, q.scale


def _prologue(x, norm_kind, norm_u, norm_eps, wht_block, a_bits):
    x = x.to(torch.float32)
    if norm_kind is not None:
        x = norm_rows(x, norm_kind, norm_u, norm_eps)
    if wht_block is not None:
        x = wht_rows(x, wht_block)
    return quant_rows(x, a_bits)


def _project(xv, xs, wv, ws, bias, packed, dct_block):
    """``_int_dot`` summed exactly, dequantized, then the block IDCT ŷ·D
    (``_idct_rows``) and the bias."""
    y = quant_matmul_plain(xv, xs, wv, ws, packed=packed)
    if dct_block is not None:
        d = transforms.dct_matrix(dct_block, device=y.device)
        y = transforms.apply_blocked(y, d, dct_block)
    if bias is not None:
        y = y + bias.reshape(1, -1).to(torch.float32)
    return y


def norm_quant_plain(x, norm_u=None, *, norm_kind=None, norm_eps=1e-6, wht_block=None,
                     a_bits=8):
    """Plain version of :func:`norm_quant`."""
    return _prologue(x, norm_kind, norm_u, norm_eps, wht_block, a_bits)


def fused_matmul_plain(x, wv, ws, xs=None, bias=None, norm_u=None, *, packed, a_bits=8,
                       norm_kind=None, norm_eps=1e-6, pro_wht_block=None, act="none",
                       epi_wht_block=None, requant_bits=None, dct_block=None):
    """Plain version of :func:`fused_matmul` (``_fused_matmul_kernel``)."""
    if xs is None:
        xv, xs = _prologue(x, norm_kind, norm_u, norm_eps, pro_wht_block, a_bits)
    else:
        xv, xs = x, xs.reshape(-1, 1).to(torch.float32)
    y = act_rows(_project(xv, xs, wv, ws, bias, packed, dct_block), act)
    if epi_wht_block is not None:
        y = wht_rows(y, epi_wht_block)
    if requant_bits is not None:
        return quant_rows(y, requant_bits)
    return y


def fused_ffn_plain(x, wu, wus, wd, wds, wg=None, wgs=None, bg=None, bu=None, bd=None,
                    norm_u=None, *, packed_g=False, packed_u=False, packed_d=False, a_bits_in=8,
                    a_bits_mid=8, norm_kind=None, norm_eps=1e-6, act="gelu",
                    pro_wht_block=None, mid_wht_block=None, idct_h=False, idct_out=False,
                    dct_block=None):
    """Plain version of :func:`fused_ffn` (``_fused_ffn_kernel``)."""
    xv, xs = _prologue(x, norm_kind, norm_u, norm_eps, pro_wht_block, a_bits_in)
    hb = dct_block if idct_h else None
    up = _project(xv, xs, wu, wus, bu, packed_u, hb)
    if wg is not None:
        h = act_rows(_project(xv, xs, wg, wgs, bg, packed_g, hb), act) * up
    else:
        h = act_rows(up, act)
    if mid_wht_block is not None:
        h = wht_rows(h, mid_wht_block)
    hq, hs = quant_rows(h, a_bits_mid)
    return _project(hq, hs, wd, wds, bd, packed_d, dct_block if idct_out else None)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes argument types of each C entry point vq_<name>
_ARGTYPES = {
    "fused_matmul": [_P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
                     _P, _P, _I, _I, _I, _I, _P],
    "fused_ffn": [_P, _P, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "norm_quant": [_P, _P, _F, _I, _I, _I, _P, _P, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The ctypes entry point ``vq_<name>`` of ``csrc/<name>.cu``."""
    fn = getattr(_build.load(name), f"vq_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def grid_for(device: torch.device, tiles: int, per_sm: int) -> int:
    """Blocks of a persistent launch: one per tile, at most ``per_sm`` per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, per_sm * sms))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(kernel: str, device: torch.device, *widths: int) -> int:
    """Blocks of ``kernel`` one SM holds at once at these widths (its
    shared memory and registers decide), from ``vq_<kernel>_blocks_per_sm``."""
    fn = getattr(_build.load(kernel), f"vq_{kernel}_blocks_per_sm")
    fn.argtypes = [_I] * len(widths) + [ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    blocks = _I(0)
    with torch.cuda.device(device):
        rc = fn(*widths, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"{kernel}: no block fits on an SM (cudaError {rc})")
    return blocks.value


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(cond: bool, kernel: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {what}")


def _check_cuda(kernel: str, dev: torch.device, **tensors) -> None:
    """Device, contiguity and 16-byte alignment of every operand."""
    for name, t in tensors.items():
        if t is None:
            continue
        _check(t.device == dev, kernel, f"{name} is on {t.device}, not {dev}")
        _check(t.is_contiguous(), kernel, f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, kernel, f"{name} must be 16-byte aligned")


def _f32(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """A per-channel vector as contiguous f32 [n] (None stays None)."""
    return None if t is None else t.reshape(n).to(torch.float32).contiguous()


def _wht_arg(kernel: str, block: Optional[int], width: int) -> int:
    if block is None:
        return 0
    _check(block >= 2 and block & (block - 1) == 0 and width % block == 0, kernel,
           f"WHT block {block} must be a power of two dividing {width}")
    return block


def _check_matmul(kernel: str, wv, packed: bool, k: int, n: int, dct_block) -> None:
    _check(wv.dtype == (torch.uint8 if packed else torch.int8), kernel, f"weight dtype {wv.dtype}")
    _check(wv.shape[0] * (2 if packed else 1) == k and wv.shape[1] == n, kernel,
           f"weight {tuple(wv.shape)} vs K={k}, N={n}")
    _check(k % (32 if packed else 16) == 0, kernel, f"K={k} must be a multiple of "
           f"{32 if packed else 16}")
    _check(n % 4 == 0, kernel, f"N={n} must be a multiple of 4")
    if dct_block is not None:
        _check(dct_block == DCT_BLOCK and n % DCT_BLOCK == 0, kernel,
               f"IDCT block {dct_block} over N={n}: the kernel takes 64-blocks")


def _launch(kernel: str, *args, nbytes: int) -> None:
    """Launch ``vq_<kernel>`` on the current stream and record it with the
    bytes its function moves (each input read once, each output written
    once; scratch is the kernel's own traffic and not counted)."""
    rc = _kernel(kernel)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    probe.record(kernel, nbytes=nbytes)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _w_bytes(k: int, n: int, packed: bool) -> int:
    return (k // 2 if packed else k) * n


def matmul_function_bytes(m: int, k: int, n: int, *, packed: bool, prequant: bool = False,
                          norm_u: bool = False, bias: bool = False, requant: bool = False,
                          idct: bool = False) -> int:
    """Bytes of :func:`fused_matmul`'s function, each moved once: x (f32,
    or int8 and its scales), the LayerNorm vector, the stored weight, its
    scales, the bias, y (f32, or int8 and its scales) and the DCT matrix."""
    x = m * k + 4 * m if prequant else 4 * m * k
    out = m * n + 4 * m if requant else 4 * m * n
    return (x + (4 * k if norm_u else 0) + _w_bytes(k, n, packed) + 4 * n
            + (4 * n if bias else 0) + out + (4 * DCT_BLOCK * DCT_BLOCK if idct else 0))


def ffn_function_bytes(m: int, d: int, dff: int, n_out: int, *, packed_u: bool,
                       packed_d: bool, packed_g: bool = False, gated: bool = False,
                       norm_u: bool = False, bias_g: bool = False, bias_u: bool = False,
                       bias_d: bool = False, idct: bool = False) -> int:
    """Bytes of :func:`fused_ffn`'s function, each moved once: x, the
    LayerNorm vector, each stored weight with its scales and bias, y and
    the DCT matrix."""
    gate = _w_bytes(d, dff, packed_g) + 4 * dff + (4 * dff if bias_g else 0) if gated else 0
    return (4 * m * d + (4 * d if norm_u else 0) + gate
            + _w_bytes(d, dff, packed_u) + 4 * dff + (4 * dff if bias_u else 0)
            + _w_bytes(dff, n_out, packed_d) + 4 * n_out + (4 * n_out if bias_d else 0)
            + 4 * m * n_out + (4 * DCT_BLOCK * DCT_BLOCK if idct else 0))


def norm_quant(x: torch.Tensor, norm_u=None, *, norm_kind: Optional[str] = None,
               norm_eps: float = 1e-6, wht_block: Optional[int] = None, a_bits: int = 8):
    """Fused prologue over f32 [M, D]: folded-norm statistics → blocked WHT
    → per-token quantization.  Returns (int8 [M, D], f32 [M, 1]).

    ``norm_u``: the LayerNorm mean-recovery vector [D] (``norm_kind="ln"``).
    """
    refuse_dtensor("norm_quant", x, norm_u)
    if x.device.type in ("cpu", "meta"):  # meta: the dry run's shapes
        return norm_quant_plain(x, norm_u, norm_kind=norm_kind, norm_eps=norm_eps,
                                wht_block=wht_block, a_bits=a_bits)
    _check(x.device.type == "cuda", "norm_quant", f"unsupported device {x.device}")
    m, d = x.shape
    _check(x.dtype == torch.float32, "norm_quant", f"x must be float32, got {x.dtype}")
    _check(d % 4 == 0, "norm_quant", f"D={d} must be a multiple of 4")
    _check(norm_kind != "ln" or norm_u is not None, "norm_quant", "ln needs norm_u")
    u = _f32(norm_u, d) if norm_kind == "ln" else None
    _check_cuda("norm_quant", x.device, x=x, u=u)
    wht = _wht_arg("norm_quant", wht_block, d)
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, s
    grid = grid_for(x.device, -(-m // ROW_WARPS), _blocks_per_sm("norm_quant", x.device, d))
    with torch.cuda.device(x.device):
        _launch("norm_quant", x.data_ptr(), _ptr(u), norm_eps, _NORMS[norm_kind], wht, a_bits,
                q.data_ptr(), s.data_ptr(), m, d, grid, nbytes=_nbytes(x, u, q, s))
    return q, s


def fused_matmul(x: torch.Tensor, wv: torch.Tensor, ws: torch.Tensor, xs=None, bias=None,
                 norm_u=None, *, packed: bool, a_bits: int = 8, norm_kind: Optional[str] = None,
                 norm_eps: float = 1e-6, pro_wht_block: Optional[int] = None, act: str = "none",
                 epi_wht_block: Optional[int] = None, requant_bits: Optional[int] = None,
                 dct_block: Optional[int] = None):
    """One launch: [prologue →] integer matmul → epilogue.

    ``x``: f32 [M, K] (prologue: norm → WHT → quantize) or int8 [M, K]
    with ``xs`` [M, 1] per-token scales (pre-quantized, e.g. the output of
    :func:`norm_quant` shared across several projections).  ``wv``/``ws``:
    int8 [K, N] (or packed uint8 [K/2, N]) + [1, N] scales.  Epilogue order:
    dequant → block IDCT → bias → act → blocked WHT → requantization.
    Returns f32 [M, N], or (int8 [M, N], f32 [M, 1]) with ``requant_bits``.
    """
    kw = dict(packed=packed, a_bits=a_bits, norm_kind=norm_kind, norm_eps=norm_eps,
              pro_wht_block=pro_wht_block, act=act, epi_wht_block=epi_wht_block,
              requant_bits=requant_bits, dct_block=dct_block)
    refuse_dtensor("fused_matmul", x, wv, ws, xs, bias, norm_u)
    if x.device.type in ("cpu", "meta"):  # meta: the dry run's shapes
        return fused_matmul_plain(x, wv, ws, xs, bias, norm_u, **kw)
    _check(x.device.type == "cuda", "fused_matmul", f"unsupported device {x.device}")
    dev = x.device
    m, k = x.shape
    n = wv.shape[-1]
    prequant = xs is not None
    if prequant:
        _check(x.dtype == torch.int8, "fused_matmul", f"pre-quantized x must be int8, got {x.dtype}")
        xs = _f32(xs, m)
    else:
        _check(x.dtype == torch.float32, "fused_matmul", f"x must be float32, got {x.dtype}")
        _check(norm_kind != "ln" or norm_u is not None, "fused_matmul", "ln needs norm_u")
    _check_matmul("fused_matmul", wv, packed, k, n, dct_block)
    _check(act in _ACTS, "fused_matmul", f"unknown activation {act!r}")
    u = _f32(norm_u, k) if (norm_kind == "ln" and not prequant) else None
    ws, bias = _f32(ws, n), _f32(bias, n)
    _check_cuda("fused_matmul", dev, x=x, xs=xs, u=u, wv=wv, ws=ws, bias=bias)
    pro_wht = 0 if prequant else _wht_arg("fused_matmul", pro_wht_block, k)
    epi_wht = _wht_arg("fused_matmul", epi_wht_block, n)
    fullrow = epi_wht > 0 or requant_bits is not None
    out = out_q = out_s = None
    if requant_bits is not None:
        out_q = torch.empty((m, n), dtype=torch.int8, device=dev)
        out_s = torch.empty((m, 1), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m > 0:
        per_sm = _blocks_per_sm("fused_matmul", dev, n, k, int(fullrow), int(prequant))
        grid = grid_for(dev, -(-m // BM), per_sm)
        # scratch: the int8 tiles of an f32 input (read only where K is too
        # wide for them to stay in shared memory), the f32 rows of a
        # full-row epilogue
        sq = None if prequant else torch.empty(grid * BM * k, dtype=torch.int8, device=dev)
        sh = torch.empty(grid * BM * n, dtype=torch.float32, device=dev) if fullrow else None
        with torch.cuda.device(dev):
            _launch(
                "fused_matmul",
                None if prequant else x.data_ptr(), x.data_ptr() if prequant else None,
                _ptr(xs), _ptr(u), norm_eps, 0 if prequant else _NORMS[norm_kind], pro_wht,
                a_bits, wv.data_ptr(), ws.data_ptr(), int(packed), _ptr(bias),
                int(dct_block is not None), _ACTS[act], epi_wht, requant_bits or 0, _ptr(out),
                _ptr(out_q), _ptr(out_s), _ptr(sq), _ptr(sh), m, n, k, grid,
                nbytes=matmul_function_bytes(
                    m, k, n, packed=packed, prequant=prequant, norm_u=u is not None,
                    bias=bias is not None, requant=requant_bits is not None,
                    idct=dct_block is not None),
            )
    return (out_q, out_s) if requant_bits is not None else out


def fused_ffn(x: torch.Tensor, wu: torch.Tensor, wus: torch.Tensor, wd: torch.Tensor,
              wds: torch.Tensor, wg=None, wgs=None, bg=None, bu=None, bd=None, norm_u=None, *,
              packed_g: bool = False, packed_u: bool = False, packed_d: bool = False,
              a_bits_in: int = 8, a_bits_mid: int = 8, norm_kind: Optional[str] = None,
              norm_eps: float = 1e-6, act: str = "gelu", pro_wht_block: Optional[int] = None,
              mid_wht_block: Optional[int] = None, idct_h: bool = False,
              idct_out: bool = False, dct_block: Optional[int] = None) -> torch.Tensor:
    """The whole (optionally gated) FFN layer in one launch.

    x f32 [M, D] → norm prologue → input WHT (``pro_wht_block``, for
    unrotated-stream flows) → per-token A-quant shared by gate/up →
    gate/up integer matmuls (+IDCT +bias) → ``act(g)·u`` (or ``act(u)``) →
    hidden blocked WHT → requantization at ``a_bits_mid`` → down integer
    matmul (+IDCT +bias) → f32 [M, d_out].  Each block of the kernel keeps
    its 64-row hidden tile in a scratch slice; the grid, and with it the
    scratch, is at most the blocks the SMs hold at once (two per SM at
    vggt-1b's widths), whatever M is.  D and d_ff up to 57,984 (a row
    buffer in one block's shared memory); above, no block fits.
    """
    kw = dict(packed_g=packed_g, packed_u=packed_u, packed_d=packed_d, a_bits_in=a_bits_in,
              a_bits_mid=a_bits_mid, norm_kind=norm_kind, norm_eps=norm_eps, act=act,
              pro_wht_block=pro_wht_block, mid_wht_block=mid_wht_block, idct_h=idct_h,
              idct_out=idct_out, dct_block=dct_block)
    refuse_dtensor("fused_ffn", x, wu, wus, wd, wds, wg, wgs, bg, bu, bd, norm_u)
    if x.device.type in ("cpu", "meta"):  # meta: the dry run's shapes
        return fused_ffn_plain(x, wu, wus, wd, wds, wg, wgs, bg, bu, bd, norm_u, **kw)
    _check(x.device.type == "cuda", "fused_ffn", f"unsupported device {x.device}")
    dev = x.device
    m, d = x.shape
    dff, n_out = wu.shape[-1], wd.shape[-1]
    _check(x.dtype == torch.float32, "fused_ffn", f"x must be float32, got {x.dtype}")
    _check(norm_kind != "ln" or norm_u is not None, "fused_ffn", "ln needs norm_u")
    _check(act in _ACTS, "fused_ffn", f"unknown activation {act!r}")
    hb = dct_block if idct_h else None
    _check_matmul("fused_ffn", wu, packed_u, d, dff, hb)
    if wg is not None:
        _check_matmul("fused_ffn", wg, packed_g, d, dff, hb)
    _check_matmul("fused_ffn", wd, packed_d, dff, n_out, dct_block if idct_out else None)
    u = _f32(norm_u, d) if norm_kind == "ln" else None
    wus, wds, wgs = _f32(wus, dff), _f32(wds, n_out), _f32(wgs, dff)
    bu, bd, bg = _f32(bu, dff), _f32(bd, n_out), _f32(bg, dff)
    _check_cuda("fused_ffn", dev, x=x, u=u, wu=wu, wus=wus, bu=bu, wd=wd, wds=wds, bd=bd,
                wg=wg, wgs=wgs, bg=bg)
    pro_wht = _wht_arg("fused_ffn", pro_wht_block, d)
    mid_wht = _wht_arg("fused_ffn", mid_wht_block, dff)
    out = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    per_sm = _blocks_per_sm("fused_ffn", dev, d, dff, int(idct_h or idct_out))
    grid = grid_for(dev, -(-m // FFN_BM), per_sm)
    sq = torch.empty(grid * FFN_BM * max(d, dff), dtype=torch.int8, device=dev)
    sh = torch.empty(grid * FFN_BM * dff, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "fused_ffn",
            x.data_ptr(), _ptr(u), norm_eps, _NORMS[norm_kind], pro_wht, a_bits_in,
            _ptr(wg), _ptr(wgs), _ptr(bg), wu.data_ptr(), wus.data_ptr(), _ptr(bu),
            wd.data_ptr(), wds.data_ptr(), _ptr(bd), int(packed_g), int(packed_u),
            int(packed_d), int(idct_h), int(idct_out), _ACTS[act], mid_wht, a_bits_mid,
            out.data_ptr(), sq.data_ptr(), sh.data_ptr(), m, d, dff, n_out, grid,
            nbytes=ffn_function_bytes(
                m, d, dff, n_out, packed_u=packed_u, packed_d=packed_d, packed_g=packed_g,
                gated=wg is not None, norm_u=u is not None, bias_g=bg is not None,
                bias_u=bu is not None, bias_d=bd is not None, idct=idct_h or idct_out),
        )
    return out
