"""Two-stage recomputation INT8 attention (paper Alg. 1).

Port of ``repro/kernels/two_stage_attention.py``.  The reference's stage ①
streams K tiles against each Q tile and keeps only the softmax statistics
``m`` (row max) and ``l`` (row sum), Eq. 8-9; stage ② recomputes Q·Kᵀ with
the final statistics, re-quantizes the probabilities to int8
(``pq = round(127·exp(s−m))``, Alg. 1 line 11) and runs an int8 P·V, so
every output tile is produced once with no rescaling (Eq. 10).

The CUDA kernel (``csrc/two_stage_attention.cu``) runs both stages in one
launch per call and computes the same function with one exponential per
score: its stage ① keeps only ``m``, and its stage ② forms
``p = exp(s−m)`` once, adds it to ``l`` and rounds it into ``pq`` — as the
plain version below does.  Its source note says what bounds it.
Conventions kept from the reference:

* scores dequantize as ``float(s_int) * qs * ks * scale`` in that order,
  with ``scale = 1/sqrt(dh)``;
* masking uses ``NEG_INF = -1e30``; causal masking is top-left aligned
  (``rows >= cols``), which equals the usual convention only at Lq == Lk;
* GQA: K/V carry ``B·kv_heads`` rows and query head ``b`` reads
  ``kv_row(b) = (b // Hq)·Hkv + (b % Hq) // g`` — no broadcast copy;
* P·V sums exactly in int32 within each ``T_V``-key tile and in float32
  across tiles; the output is ``acc·(1/127)/max(l, 1e-30)·v_scale``.

Unlike the TPU kernel, lengths need no padding: the CUDA kernel masks the
ragged tails of Lq and Lk itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, probe
from repro_torch.sharded import refuse_dtensor

__all__ = ["two_stage_attention", "two_stage_attention_plain", "function_bytes", "NEG_INF",
           "T_V", "LAUNCH_TILES", "HEAD_DIMS"]

NEG_INF = -1e30
T_V = 2048  # keys per int32 P·V partial before the float32 carry (as in the kernel)
# The tiles the kernel launches with (csrc/two_stage_attention.cu): 128
# query rows a block (``BQ``, 16 per warp x 8 warps), 64-key tiles
# (``BKT``) and the 2048-key int32 carry period (``TV_TILES`` tiles).
LAUNCH_TILES = {"bq": 128, "bk": 64, "bkv": T_V}
# The head dims the kernel has instances for: vggt-1b's 64, its smoke
# width's 32, phi3-mini-3.8b's 96, qwen3-14b's 128 and paligemma-3b's 256
# (whose launch splits the output columns in two halves across the grid).
HEAD_DIMS = (32, 64, 96, 128, 256)

_fn = None


def _kv_rows(bh: int, q_heads: int | None, kv_heads: int | None, bhkv: int) -> list[int]:
    if q_heads is None or kv_heads is None or q_heads == kv_heads:
        if bhkv != bh:
            raise ValueError(f"K/V carry {bhkv} heads for {bh} query heads; pass q_heads/kv_heads")
        return list(range(bh))
    if q_heads % kv_heads or bh % q_heads or bhkv != bh // q_heads * kv_heads:
        raise ValueError(f"bad GQA shapes: bh={bh} bhkv={bhkv} q_heads={q_heads} kv_heads={kv_heads}")
    g = q_heads // kv_heads
    return [(b // q_heads) * kv_heads + (b % q_heads) // g for b in range(bh)]


def two_stage_attention_plain(
    qv: torch.Tensor,
    qs: torch.Tensor,
    kv: torch.Tensor,
    ks: torch.Tensor,
    vv: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    causal: bool = False,
    q_heads: int | None = None,
    kv_heads: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version, one head at a time (so at most one [Lq, Lk]
    score matrix exists at once).  Integer products sum exactly in
    float64; everything else follows the kernel's float32 op order."""
    bh, lq, dh = qv.shape
    lk = kv.shape[1]
    scale = 1.0 / math.sqrt(dh)
    rows = _kv_rows(bh, q_heads, kv_heads, kv.shape[0])
    qs = qs.reshape(bh, lq, 1)
    ks = ks.reshape(kv.shape[0], 1, lk)
    v_scale = v_scale.reshape(bh)
    out = torch.empty((bh, lq, dh), dtype=torch.float32, device=qv.device)
    if causal:
        keep = torch.arange(lq, device=qv.device)[:, None] >= torch.arange(lk, device=qv.device)[None, :]
    for b in range(bh):
        kb = rows[b]
        s = (qv[b].to(torch.float64) @ kv[kb].to(torch.float64).T).to(torch.float32)
        s = s * qs[b] * ks[kb] * scale
        if causal:
            s = torch.where(keep, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        pq = torch.round(p * 127.0)
        del p
        acc = torch.zeros((lq, dh), dtype=torch.float32, device=qv.device)
        vb = vv[kb].to(torch.float64)
        for c0 in range(0, lk, T_V):
            acc += (pq[:, c0 : c0 + T_V].to(torch.float64) @ vb[c0 : c0 + T_V]).to(torch.float32)
        out[b] = acc * (1.0 / 127.0) / l * v_scale[b]
    return out


def function_bytes(bh: int, bhkv: int, lq: int, lk: int, dh: int) -> int:
    """Bytes of the function: int8 q/k/v and their f32 scales in, f32 out
    (what a launch records in ``kernels.probe``)."""
    return bh * lq * (dh + 4) + bhkv * lk * (2 * dh + 4) + 4 * bh + 4 * bh * lq * dh


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("two_stage_attention").vq_two_stage_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"two_stage_attention: {what}")


def two_stage_attention(
    qv: torch.Tensor,
    qs: torch.Tensor,
    kv: torch.Tensor,
    ks: torch.Tensor,
    vv: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    causal: bool = False,
    q_heads: int | None = None,
    kv_heads: int | None = None,
) -> torch.Tensor:
    """Two-stage INT8 attention over [BH, L, dh] int8 tensors.

    qv [BH, Lq, dh], kv/vv [BHkv, Lk, dh] int8; qs [BH, Lq, 1] and
    ks [BHkv, Lk, 1] f32 per-token scales; v_scale [BH, 1, 1] f32 per
    *query* head.  Returns [BH, Lq, dh] float32.  GQA when ``q_heads`` and
    ``kv_heads`` differ.
    """
    refuse_dtensor("two_stage_attention", qv, qs, kv, ks, vv, v_scale)
    if qv.device.type == "cpu":
        return two_stage_attention_plain(
            qv, qs, kv, ks, vv, v_scale, causal=causal, q_heads=q_heads, kv_heads=kv_heads,
        )
    if qv.device.type != "cuda":
        raise ValueError(f"two_stage_attention: unsupported device {qv.device}")
    bh, lq, dh = qv.shape
    bhkv, lk = kv.shape[0], kv.shape[1]
    _kv_rows(bh, q_heads, kv_heads, bhkv)  # validates the GQA shapes
    hq = q_heads if q_heads is not None and kv_heads is not None else 1
    hkv = kv_heads if q_heads is not None and kv_heads is not None else 1
    _check(dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    _check(qv.dtype == kv.dtype == vv.dtype == torch.int8, "q/k/v values must be int8")
    _check(tuple(vv.shape) == tuple(kv.shape), "kv and vv shapes differ")
    _check(qs.numel() == bh * lq and ks.numel() == bhkv * lk and v_scale.numel() == bh,
           "scale shapes")
    tensors = (qv, qs, kv, ks, vv, v_scale)
    for t in tensors:
        _check(t.device == qv.device, "all operands on one device")
        _check(t.is_contiguous(), "operands must be contiguous")
    for t in (qs, ks, v_scale):
        _check(t.dtype == torch.float32, "scales must be float32")
    for t in (qv, kv, vv):
        _check(t.data_ptr() % 16 == 0, "int8 operands must be 16-byte aligned")
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((bh, lq, dh), dtype=torch.float32, device=qv.device)
    if bh == 0 or lq == 0:
        return out
    _check(lk > 0, "no keys")
    with torch.cuda.device(qv.device):
        rc = _kernel()(
            qv.data_ptr(), qs.data_ptr(), kv.data_ptr(), ks.data_ptr(), vv.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(), bh, lq, lk, dh, hq, hkv, int(causal),
            scale, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"two_stage_attention kernel launch failed: cudaError {rc}")
    probe.record("two_stage_attention", nbytes=function_bytes(bh, bhkv, lq, lk, dh))
    return out
