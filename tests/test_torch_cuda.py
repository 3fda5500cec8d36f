"""CUDA kernels of the PyTorch port vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels build at first use); skips
elsewhere.  Imports no JAX, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import quantize_per_token, quantize_weight
from repro_torch.kernels import ops, probe
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import two_stage_attention as tsa

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, dev):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)


_MM_SHAPES = [(1, 64, 4), (37, 128, 132), (130, 256, 260), (300, 1024, 512), (129, 96, 64)]
# inputs at +-127 with rank-one signs on even columns: |acc| = 4096 * 127^2,
# past 2^24, so the f32 conversion of the int32 sum rounds
_SATURATED = {(False, 300, 4096, 256)}


# The kernel runs 128 x 256 output tiles, each of two 64-row warpgroups,
# over 64-deep K steps (W4: 32 packed rows) through a 4-slot load ring.
# K=32 (W8) is a single step; K=96 ends in a partial K step (W4: 48 packed
# rows of a 32-row step), K=48 too (W8 only: packing needs K % 32 == 0),
# K=1056 after 16.5 steps in a partial ring pass; N=132/260/388 end in a
# partial N tile with N % 16 != 0 (4-byte weight copies), N=64/400 with
# N % 16 == 0; M=1/37/65/129/130/191 leave a partial M tile or warpgroup;
# M=16464 is the served w_down and w_up.
@pytest.mark.parametrize(
    "packed,m,k,n",
    [(p, *s) for p in (False, True) for s in _MM_SHAPES] + [(False, 65, 48, 36)]
    + [(False, 64, 32, 128), (True, 65, 256, 128), (False, 191, 512, 256),
       (True, 129, 256, 132), (False, 200, 128, 388), (True, 96, 96, 388),
       (True, 77, 1056, 400), (False, 150, 1056, 128), *_SATURATED,
       (True, 16464, 4096, 1024), (True, 16464, 1024, 4096)],
)
def test_quant_matmul_matches_plain(dev, packed, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = _normal(rng, (m, k), dev)
    wq = quantize_weight(_normal(rng, (k, n), dev), 4 if packed else 8)
    xq = quantize_per_token(x, 8)
    xv, xs, wv, ws = xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1)
    if (packed, m, k, n) in _SATURATED:
        def sign(*shape):
            return torch.as_tensor(rng.choice([-127, 127], size=shape).astype(np.int8))

        t = sign(k) // 127
        xv = (sign(m, 1) * t).to(dev)  # row m: +-127 * t[k]
        w = sign(k, n)
        w[:, ::2] = t.reshape(-1, 1) * sign(1, n // 2)  # even columns: +-127 * t[k]
        wv = w.to(dev)
        assert (xv.double() @ wv.double()).abs().max() > 2**24
    with probe.tracking() as log:
        got = qm.quant_matmul(xv, xs, wv, ws, packed=packed)
    torch.cuda.synchronize()
    want = qm.quant_matmul_plain(xv, xs, wv, ws, packed=packed)
    assert log.by_name() == {"quant_matmul": 1}
    # the integer part is exact; only the two float scale multiplies round
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_quant_matmul_rejects_w4_k_past_2_17(dev):
    """W4 sums 16 w exactly in int32, which holds for K < 2^17."""
    k = 1 << 17
    xv = torch.ones((1, k), dtype=torch.int8, device=dev)
    wv = torch.zeros((k // 2, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        qm.quant_matmul(xv, torch.ones(1, device=dev), wv, torch.ones(4, device=dev), packed=True)


def test_quant_matmul_unaligned_weights(dev):
    """Weights 4 bytes off a 16-byte boundary take the 4-byte copies even
    at N % 16 == 0."""
    rng = np.random.default_rng(5)
    for packed in (False, True):
        xq = quantize_per_token(_normal(rng, (130, 256), dev), 8)
        wq = quantize_weight(_normal(rng, (256, 256), dev), 4 if packed else 8)
        buf = torch.empty(wq.values.numel() + 4, dtype=wq.values.dtype, device=dev)
        wv = buf[4:].view(wq.values.shape)
        wv.copy_(wq.values)
        assert wv.data_ptr() % 16 == 4
        ws = wq.scale.reshape(1, -1)
        got = qm.quant_matmul(xq.values, xq.scale, wv, ws, packed=packed)
        want = qm.quant_matmul_plain(xq.values, xq.scale, wq.values, ws, packed=packed)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_quant_matmul_rejects_bad_k(dev):
    xq = quantize_per_token(torch.ones(4, 24, device=dev), 8)
    wq = quantize_weight(torch.ones(24, 8, device=dev), 8)
    with pytest.raises(ValueError):
        qm.quant_matmul(xq.values, xq.scale, wq.values, wq.scale, packed=False)


# The kernel runs 128-row Q tiles over 64-key tiles and flushes its int32
# P.V sums every 2048 keys (T_V): Lk 2049/4097 end just past a flush, Lq
# 129/1029 and a single row leave a ragged Q tile, causal runs at Lq == Lk
# (the convention the kernel and the plain version share), and an all-zero
# query row scores 0 against every key, so its l is exactly Lk.
@pytest.mark.parametrize(
    "b,h,hkv,lq,lk,dh,causal,zero_row",
    [
        (1, 2, 2, 64, 64, 64, False, None),
        (2, 4, 4, 42, 42, 32, False, None),
        (1, 4, 4, 200, 200, 64, True, None),
        (1, 4, 2, 130, 130, 64, False, None),
        (1, 4, 1, 77, 77, 64, True, None),
        (1, 2, 2, 40, 2100, 64, False, None),
        (1, 2, 2, 129, 2049, 64, False, None),
        (1, 2, 2, 129, 4097, 32, False, None),
        (1, 2, 2, 1029, 1029, 64, False, None),
        (1, 4, 4, 1, 300, 64, False, None),
        (1, 4, 4, 1, 2049, 32, False, None),
        (2, 4, 1, 129, 1029, 64, False, None),
        (1, 2, 2, 1029, 1029, 64, True, None),
        (1, 2, 2, 129, 129, 32, True, None),
        (1, 2, 2, 130, 2100, 64, False, 5),
        (1, 2, 2, 33, 4097, 32, False, 0),
        # head dim 128 (qwen3-14b): GQA 40/8 and MHA, causal at Lq == Lk,
        # ragged L 129 and 1029
        (1, 40, 8, 129, 129, 128, True, None),
        (2, 40, 8, 129, 1029, 128, False, None),
        (1, 4, 4, 1029, 1029, 128, True, None),
        (1, 2, 2, 1029, 1029, 128, False, None),
        (1, 40, 8, 1029, 1029, 128, True, None),
        (1, 2, 2, 130, 2100, 128, False, 5),
        # head dim 96 (phi3-mini-3.8b, MHA): causal at Lq == Lk, ragged L
        # 129 and 1029, Lq != Lk non-causal, a zero row past a T_V flush
        (1, 4, 4, 129, 129, 96, True, None),
        (1, 4, 4, 1029, 1029, 96, True, None),
        (1, 2, 2, 1000, 1500, 96, False, None),
        (1, 2, 2, 130, 2100, 96, False, 5),
        (2, 32, 32, 129, 129, 96, False, None),
        # head dim 256 (paligemma-3b, MQA 8/1; its output columns split in
        # two blocks): causal, ragged L, Lq != Lk non-causal, MHA, a zero row
        (1, 8, 1, 129, 129, 256, True, None),
        (2, 8, 1, 1029, 1029, 256, True, None),
        (1, 8, 1, 1000, 1500, 256, False, None),
        (1, 2, 2, 33, 4097, 256, False, 0),
        (1, 4, 4, 200, 200, 256, True, None),
    ],
)
def test_two_stage_matches_plain(dev, b, h, hkv, lq, lk, dh, causal, zero_row):
    rng = np.random.default_rng(lq * 7 + lk + dh)
    q = _normal(rng, (b, h, lq, dh), dev)
    k = _normal(rng, (b, hkv, lk, dh), dev)
    v = _normal(rng, (b, hkv, lk, dh), dev)
    if zero_row is not None:
        q[:, :, zero_row] = 0
    with probe.tracking() as log:
        got = ops.two_stage_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert log.by_name() == {"two_stage_attention": 1}
    qq = quantize_per_token(q.reshape(b * h, lq, dh), 8)
    kq = quantize_per_token(k.reshape(b * hkv, lk, dh), 8)
    vf = v.reshape(b * hkv, lk, dh)
    vscale = torch.clamp_min(vf.abs().amax(dim=(1, 2), keepdim=True), 1e-8) / 127.0
    vv = torch.round(vf / vscale).clamp(-127, 127).to(torch.int8)
    vsq = vscale.reshape(b, hkv).repeat_interleave(h // hkv, dim=1).reshape(b * h, 1, 1)
    gqa = dict(q_heads=h, kv_heads=hkv) if h != hkv else {}
    want = tsa.two_stage_attention_plain(
        qq.values, qq.scale, kq.values, kq.scale, vv, vsq, causal=causal, **gqa
    )
    got = got.reshape(b * h, lq, dh)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    if zero_row is not None:  # p = 1 for every key: pq = 127, l = Lk
        mean = vv.float().sum(dim=1).repeat_interleave(h // hkv, dim=0) / lk * vsq.reshape(-1, 1)
        torch.testing.assert_close(got[:, zero_row], mean, rtol=1e-6, atol=1e-7)


def test_two_stage_refuses_other_head_dims(dev):
    """Only dh 32, 64, 96, 128 and 256 have kernel instances; dh 80 raises
    in the wrapper before any launch."""
    qv = torch.zeros((2, 16, 80), dtype=torch.int8, device=dev)
    s = torch.ones((2, 16, 1), device=dev)
    with probe.tracking() as log, pytest.raises(ValueError, match="head dim 80"):
        tsa.two_stage_attention(qv, s, qv, s, qv, torch.ones((2, 1, 1), device=dev))
    assert log.count == 0


@pytest.mark.parametrize("dh", [32, 64, 96, 128, 256])
def test_two_stage_instances_do_not_spill(dev, dh):
    """Every instance fits its registers (``vq_two_stage_attention_attrs``
    out[3], local memory a thread, is 0) and its shared memory: dh 96, 128
    and 256 one block per SM, dh 32 and 64 two."""
    import math

    from repro_torch.kernels import _build
    from repro_torch.kernels.measure import kernel_attrs

    a = kernel_attrs(_build.load("two_stage_attention"), "two_stage_attention", dh,
                     1.0 / math.sqrt(dh))
    assert a["spill_bytes"] == 0, a
    assert a["blocks_per_sm"] == (1 if dh >= 96 else 2), a
    assert a["smem_per_block"] <= 232448, a


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", [(17408, 5120), (5120, 17408)])
def test_quant_matmul_decode_rows_w4(dev, m, k, n):
    """Decode's few rows at qwen3-14b's W4 widths: w_down (K 17,408) and
    w_up (N 17,408)."""
    rng = np.random.default_rng(m * 31 + k)
    xq = quantize_per_token(_normal(rng, (m, k), dev), 8)
    wq = quantize_weight(_normal(rng, (k, n), dev), 4)
    ws = wq.scale.reshape(1, -1)
    with probe.tracking() as log:
        got = qm.quant_matmul(xq.values, xq.scale, wq.values, ws, packed=True)
    torch.cuda.synchronize()
    want = qm.quant_matmul_plain(xq.values, xq.scale, wq.values, ws, packed=True)
    assert log.by_name() == {"quant_matmul": 1}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# unified datapath: fused_matmul, fused_ffn, norm_quant, wht
# ---------------------------------------------------------------------------
#
# Kernel and plain version quantize the same float values, but their sums
# (norm statistics, the H_128 factor, the IDCT) run in different orders,
# so an int8 value sitting within an ulp of a rounding boundary may differ
# by one step (about 1 in 1e5 entries).  Int8 outputs are held to ±1 on at
# most 0.1% of the entries.  One flipped input entry moves its output row
# by ~1e-3 relative, so float outputs fed by an in-kernel quantization are
# held to rel L2 1e-3 against the plain version; against the plain version
# fed the kernel's own int8 input (norm_quant runs the same device code as
# fused_matmul's prologue) they are held to 1e-5.


def _rel(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


def _assert_q_close(got, want, what):
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(d.max()) <= 1, what
    assert int((d > 0).sum()) <= max(2, d.numel() // 1000), (what, int((d > 0).sum()))


from repro_torch.core import versaq as tvq  # noqa: E402
from repro_torch.kernels import fused as fz  # noqa: E402
from repro_torch.kernels import wht as whtk  # noqa: E402

# m = WRAP is one ragged tile more than the persistent grid covers in one
# pass at the case's widths, so some blocks take a second tile.
WRAP = -1

# (m, k, n, w_bits, a_bits, norm, pro_wht, act, epi_wht, requant, idct, bias,
# prequant).  K 2816 is the widest input whose int8 tile stays in shared
# memory; K 2880 (and the pre-quantized K 4096) streams it through the ring.
# N 192 ends in a half-empty N tile with the IDCT on; the last case is the
# served wo.
_FM_CASES = [
    (13, 128, 192, 8, 8, "rms", True, "none", False, None, True, True, False),
    (130, 256, 256, 4, 8, "ln", True, "gelu", False, None, True, True, False),
    (77, 128, 256, 4, 4, None, False, "silu", True, 4, False, True, False),
    (200, 128, 132, 8, 8, None, False, "none", False, None, False, False, True),
    (33, 512, 512, 4, 8, "ln", True, "gelu", True, 8, True, False, False),
    (300, 1024, 3072, 4, 8, "ln", True, "none", False, None, True, True, False),
    (129, 4096, 1024, 4, 8, None, False, "none", False, None, True, True, True),
    (1, 1024, 3072, 4, 8, "ln", False, "none", False, None, True, True, False),
    (0, 1024, 1024, 4, 8, None, False, "none", False, None, True, True, False),
    (WRAP, 1024, 3072, 4, 8, "ln", False, "none", False, None, True, True, False),
    (70, 2816, 256, 4, 8, "ln", False, "none", False, None, True, True, False),
    (70, 2880, 256, 4, 8, "ln", False, "none", False, None, True, True, False),
    (100, 1024, 192, 4, 8, "ln", False, "gelu", False, None, True, True, False),
    (16464, 1024, 1024, 4, 8, None, False, "none", False, None, True, True, False),
]


@pytest.mark.parametrize("case", _FM_CASES)
def test_fused_matmul_matches_plain(dev, case):
    m, k, n, wb, ab, norm, pwht, act, ewht, rq, idct, has_bias, preq = case
    if m == WRAP:
        per_sm = fz._blocks_per_sm("fused_matmul", dev, n, k, int(ewht or rq is not None),
                                   int(preq))
        m = fz.grid_for(dev, 1 << 30, per_sm) * fz.BM + 129
    rng = np.random.default_rng(m + k + n)
    x = _normal(rng, (m, k), dev)
    w = _normal(rng, (k, n), dev) / np.sqrt(k)
    wq = quantize_weight(w, wb)
    bias = _normal(rng, (n,), dev) if has_bias else None
    u = tvq.make_folded_norm("ln", k, device=dev).u if norm == "ln" else None
    kw = dict(packed=wq.packed, a_bits=ab, norm_kind=norm, pro_wht_block=k if pwht else None,
              act=act, epi_wht_block=n if ewht else None, requant_bits=rq,
              dct_block=64 if idct else None)
    xs = None
    if preq:
        xq = quantize_per_token(x, ab)
        x, xs = xq.values, xq.scale
        kw.update(norm_kind=None, pro_wht_block=None)
    args = (x, wq.values, wq.scale.reshape(1, -1), xs, bias, u)
    with probe.tracking() as log:
        got = fz.fused_matmul(*args, **kw)
    torch.cuda.synchronize()
    assert log.by_name() == ({"fused_matmul": 1} if m else {})  # no rows, no launch
    want = fz.fused_matmul_plain(*args, **kw)
    if rq is None:
        assert got.shape == (m, n) and _rel(got, want) < (1e-5 if preq else 1e-3), _rel(got, want)
        if not preq:
            q, s = fz.norm_quant(x, u, norm_kind=norm, wht_block=kw["pro_wht_block"], a_bits=ab)
            exact = fz.fused_matmul_plain(q, *args[1:3], s, bias, **{**kw, "norm_kind": None})
            assert _rel(got, exact) < 1e-5, _rel(got, exact)
    else:
        _assert_q_close(got[0], want[0], "requant values")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)


# (m, d, dff, w_bits, a_bits, gated, norm, pro_wht, idct, bias); m = WRAP as
# above.  d_ff 384 (3 groups of 128) takes the register row pass with a
# partial warp, d_ff 192 (not a multiple of 128; hidden WHT block 64) the
# one-warp-a-row pass.  D 2816 is
# the widest input (a multiple of 64) whose int8 tile stays in shared
# memory; from D 2880 it is streamed from scratch, up to FFN_MAX_D.
FFN_MAX_D = 57984
_FFN_CASES = [
    (29, 128, 256, 4, 8, False, "ln", False, True, True),
    (32, 128, 256, 8, 8, True, "rms", False, True, False),
    (77, 128, 256, 4, 4, True, None, True, False, False),
    (300, 1024, 4096, 4, 8, False, "ln", False, True, True),
    (1, 1024, 4096, 4, 8, False, "ln", False, True, True),
    (0, 1024, 4096, 4, 8, False, "ln", False, True, True),
    (129, 1024, 4096, 4, 8, False, "ln", False, True, True),
    (WRAP, 1024, 4096, 4, 8, False, "ln", False, True, True),
    (300, 1024, 2816, 4, 8, True, "rms", False, True, True),
    (50, 128, 384, 4, 8, False, "ln", False, True, True),
    (40, 128, 192, 8, 8, False, "rms", False, True, True),
    (70, 2816, 256, 4, 8, False, "ln", False, True, True),
    (70, 2880, 256, 4, 8, False, "ln", False, True, True),
    (65, 2880, 256, 8, 8, True, "rms", False, True, False),
    (3, FFN_MAX_D, 128, 4, 8, False, "ln", False, True, True),
]


@pytest.mark.parametrize("case", _FFN_CASES)
def test_fused_ffn_matches_plain(dev, case):
    m, d, dff, wb, ab, gated, norm, pwht, idct, has_bias = case
    if m == WRAP:
        grid = fz.grid_for(dev, 1 << 30, fz._blocks_per_sm("fused_ffn", dev, d, dff, int(idct)))
        m = grid * fz.FFN_BM + 129
    rng = np.random.default_rng(m + d + dff)
    x = _normal(rng, (m, d), dev)
    wu = quantize_weight(_normal(rng, (d, dff), dev) / np.sqrt(d), wb)
    wd = quantize_weight(_normal(rng, (dff, d), dev) / np.sqrt(dff), wb)
    wg = quantize_weight(_normal(rng, (d, dff), dev) / np.sqrt(d), wb) if gated else None
    bu = _normal(rng, (dff,), dev) if has_bias else None
    bd = _normal(rng, (d,), dev) if has_bias else None
    u = tvq.make_folded_norm("ln", d, device=dev).u if norm == "ln" else None
    args = (x, wu.values, wu.scale.reshape(1, -1), wd.values, wd.scale.reshape(1, -1),
            None if wg is None else wg.values, None if wg is None else wg.scale.reshape(1, -1),
            None, bu, bd, u)
    kw = dict(packed_g=gated and wg.packed, packed_u=wu.packed, packed_d=wd.packed,
              a_bits_in=ab, a_bits_mid=ab, norm_kind=norm, act="silu" if gated else "gelu",
              pro_wht_block=d if pwht else None, mid_wht_block=dff & -dff, idct_h=idct,
              idct_out=idct, dct_block=64 if idct else None)
    with probe.tracking() as log:
        got = fz.fused_ffn(*args, **kw)
    torch.cuda.synchronize()
    assert log.by_name() == ({"fused_ffn": 1} if m else {})  # no rows, no launch
    want = fz.fused_ffn_plain(*args, **kw)
    # a ±1 flip of one requantized hidden entry moves its row by ~1e-3
    assert got.shape == (m, d) and _rel(got, want) < 1e-3, _rel(got, want)


def test_fused_ffn_rejects_rows_wider_than_a_block(dev):
    d = FFN_MAX_D + 64
    wu = torch.zeros((d // 2, 128), dtype=torch.uint8, device=dev)
    wd = torch.zeros((64, d), dtype=torch.uint8, device=dev)
    ones = torch.ones((1, 128), device=dev)
    with pytest.raises(RuntimeError, match="no block fits"):
        fz.fused_ffn(torch.zeros((3, d), device=dev), wu, ones, wd, torch.ones((1, d), device=dev),
                     packed_u=True, packed_d=True)


# Register rows (D a multiple of 128, at most 4096: 21x256, 130x1024, the
# served 16464x1024, 999x4096 at A4, 77x768 and 50x768 without the WHT,
# whose 6 chunks a lane fill 6 of an instance's 8) and the shared-memory
# routine (7x96).
@pytest.mark.parametrize("norm", [None, "rms", "ln"])
@pytest.mark.parametrize("bits,wht,m,d", [(8, True, 21, 256), (4, True, 130, 1024),
                                          (8, False, 7, 96), (8, True, 16464, 1024),
                                          (4, True, 999, 4096), (8, True, 77, 768),
                                          (8, False, 50, 768)])
def test_norm_quant_matches_plain(dev, norm, bits, wht, m, d):
    x = _normal(np.random.default_rng(m + d), (m, d), dev)
    u = tvq.make_folded_norm("ln", d, device=dev).u if norm == "ln" else None
    kw = dict(norm_kind=norm, wht_block=(d & -d) if wht else None, a_bits=bits)
    with probe.tracking() as log:
        q, s = fz.norm_quant(x, u, **kw)
    torch.cuda.synchronize()
    assert log.by_name() == {"norm_quant": 1}
    wq, ws = fz.norm_quant_plain(x, u, **kw)
    _assert_q_close(q, wq, "norm_quant values")
    torch.testing.assert_close(s, ws, rtol=1e-6, atol=0)


def _wave_rows(dev, kernel, d):
    """One row past what the persistent grid's warps take in one pass at
    width d, so one warp takes a second row."""
    per_sm = fz._blocks_per_sm(kernel, dev, d)
    return fz.grid_for(dev, 1 << 30, per_sm) * fz.ROW_WARPS + 1


@pytest.mark.parametrize("d", [1024, 4096, 96])
def test_norm_quant_one_row_past_a_wave(dev, d):
    m = _wave_rows(dev, "norm_quant", d)
    x = _normal(np.random.default_rng(d), (m, d), dev)
    u = tvq.make_folded_norm("ln", d, device=dev).u
    kw = dict(norm_kind="ln", wht_block=d & -d, a_bits=8)
    q, s = fz.norm_quant(x, u, **kw)
    wq, ws = fz.norm_quant_plain(x, u, **kw)
    _assert_q_close(q, wq, "norm_quant values")
    torch.testing.assert_close(s, ws, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [1024, 96])
def test_norm_quant_zero_and_nan_rows(dev, d):
    """An all-zero row takes the amax floor (scale 1e-8 / 127, values 0); a
    NaN in a row makes its scale NaN, so its dequantized values are NaN;
    the other rows are untouched by either."""
    x = _normal(np.random.default_rng(5), (9, d), dev)
    x[2] = 0.0
    x[6, 17] = float("nan")
    kw = dict(norm_kind="rms", wht_block=d & -d, a_bits=8)
    q, s = fz.norm_quant(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q[2], torch.zeros_like(q[2]))
    assert s[2, 0].item() == (torch.tensor(1e-8, dtype=torch.float32) / 127.0).item()
    assert torch.isnan(s[6, 0]) and torch.isnan(q[6].float() * s[6]).all()
    keep = [i for i in range(9) if i != 6]
    wq, ws = fz.norm_quant_plain(x[keep], **kw)
    _assert_q_close(q[keep], wq, "norm_quant values")
    torch.testing.assert_close(s[keep], ws, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits,d", [(8, 1024), (4, 4096), (8, 96)])
def test_norm_quant_divides_exactly(dev, bits, d):
    """Without norm and WHT the kernel quantizes x itself: its values are
    round-half-even(x / s) clamped, with IEEE division by its own scale s
    = max(amax, 1e-8) / qmax, bit for bit.  Rows span magnitudes from 1e-30
    to 1e30 (and the amax floor), and some hold exact and near ties
    (k + 1/2) s, one ulp either side."""
    rng = np.random.default_rng(bits + d)
    x = _normal(rng, (600, d), dev) * torch.as_tensor(
        10.0 ** rng.uniform(-30, 30, size=(600, 1)).astype(np.float32), device=dev)
    x[0] *= 1e-12
    qmax = 2 ** (bits - 1) - 1
    k = torch.as_tensor(rng.integers(-qmax, qmax, size=(100, d)).astype(np.float32), device=dev)
    sc = torch.as_tensor(10.0 ** rng.uniform(-5, 5, size=(100, 1)).astype(np.float32), device=dev)
    ties = (k + 0.5) * sc
    ties[:, 0] = qmax * sc[:, 0]
    ties[:, 1::3] = torch.nextafter(ties[:, 1::3], torch.full_like(ties[:, 1::3], float("inf")))
    ties[:, 2::3] = torch.nextafter(ties[:, 2::3], torch.full_like(ties[:, 2::3], -float("inf")))
    x = torch.cat([x, ties])
    q, s = fz.norm_quant(x, a_bits=bits)
    torch.cuda.synchronize()
    amax = x.abs().amax(dim=1, keepdim=True)
    assert torch.equal(s, torch.clamp_min(amax, 1e-8) / torch.full_like(amax, qmax))
    assert torch.equal(q, torch.round(x / s).clamp(-qmax, qmax).to(torch.int8))


@pytest.mark.parametrize("m", [333, 16464])
def test_fused_matmul_prologue_equals_norm_quant(dev, m):
    """wqkv's widths (K=1024, N=3072, W4A8, IDCT, bias) with the ln + WHT
    prologue: fused_matmul's own prologue and its pre-quantized path fed by
    norm_quant give the same outputs bit for bit, since norm_quant
    computes what the prologue computes."""
    k, n = 1024, 3072
    rng = np.random.default_rng(m)
    x = _normal(rng, (m, k), dev)
    wq = quantize_weight(_normal(rng, (k, n), dev) / np.sqrt(k), 4)
    bias = _normal(rng, (n,), dev)
    u = tvq.make_folded_norm("ln", k, device=dev).u
    ws = wq.scale.reshape(1, -1)
    own = fz.fused_matmul(x, wq.values, ws, None, bias, u, packed=True, norm_kind="ln",
                          pro_wht_block=k, dct_block=64)
    q, s = fz.norm_quant(x, u, norm_kind="ln", wht_block=k)
    fed = fz.fused_matmul(q, wq.values, ws, s, bias, packed=True, dct_block=64)
    torch.cuda.synchronize()
    assert torch.equal(own, fed), (own - fed).abs().max().item()


# Register rows (d a multiple of 128, at most 4096; 768 fills 6 of an
# instance's 8 chunks a lane; block 4096 at the served 16464x4096) and the
# shared-memory routine (d 64 and 12, not multiples of 128).
@pytest.mark.parametrize("r,d,block", [(5, 64, None), (37, 256, None), (300, 4096, None),
                                       (64, 1024, 128), (3, 12, 4), (16464, 4096, None),
                                       (77, 768, None), (40, 1024, 64)])
def test_wht_matches_plain(dev, r, d, block):
    x = _normal(np.random.default_rng(r + d), (r, d), dev)
    with probe.tracking() as log:
        got = whtk.wht(x, block=block)
    torch.cuda.synchronize()
    assert log.by_name() == {"wht": 1}
    want = whtk.wht_plain(x, block=block)
    assert _rel(got, want) < 1e-6, _rel(got, want)


@pytest.mark.parametrize("d", [4096, 1024, 64])
def test_wht_one_row_past_a_wave(dev, d):
    r = _wave_rows(dev, "wht", d)
    x = _normal(np.random.default_rng(d), (r, d), dev)
    got = whtk.wht(x)
    assert _rel(got, whtk.wht_plain(x)) < 1e-6


def test_wht_zero_and_nan_rows(dev):
    """A zero row stays zero; a NaN fills its block with NaN and nothing
    else (block 1024 of d 4096)."""
    x = _normal(np.random.default_rng(6), (6, 4096), dev)
    x[1] = 0.0
    x[4, 2000] = float("nan")
    got = whtk.wht(x, block=1024)
    torch.cuda.synchronize()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.isnan(got[4, 1024:2048]).all() and torch.isfinite(got[4, :1024]).all()
    assert torch.isfinite(got[4, 2048:]).all()
    keep = [0, 1, 2, 3, 5]
    assert _rel(got[keep], whtk.wht_plain(x[keep], block=1024)) < 1e-6


def test_fused_ops_wrappers_launch_kernels(dev):
    """The ops wrappers on CUDA tensors: a norm_quant prologue shared by a
    pre-quantized fused_linear, and online_wht_2d."""
    rng = np.random.default_rng(3)
    x = _normal(rng, (4, 9, 128), dev)
    ql = tvq.prepare_linear(_normal(rng, (128, 64), dev), tvq.QuantPolicy(8, 8, "rtn"),
                            use_kernel=True, epilogue=tvq.Epilogue())
    with probe.tracking() as log:
        qt = ops.norm_quant_prologue(x, norm="rms", a_bits=8)
        y = ops.fused_linear(qt, ql)
        r = ops.online_wht_2d(x)
    torch.cuda.synchronize()
    assert log.by_name() == {"norm_quant": 1, "fused_matmul": 1, "wht": 1}
    assert y.shape == (4, 9, 64) and r.shape == x.shape
    want = tvq.apply_linear(
        tvq.QuantLinear(qw=ql.qw), tvq.folded_norm_stats(x, "rms", None, 1e-6))
    assert _rel(y, want) < 1e-5


def test_fused_engine_serves_masked_bucket(dev):
    """A patch-padded (masked) bucket under the fused plan: the projections
    and FFNs still launch their kernels, only the attention takes the
    emulation.  The served outputs are those of a kernel forward of the same
    padded, masked batch, and every block's two residual branches (attention
    and FFN), fed the stream that forward reaches the block with, are held
    against the same block with the plain versions at 1e-3.  The branches,
    not the outputs, are held to the plain versions: at LayerScale 0.2 a
    ±1 rounding flip of one quantized activation moves this batch's pose by
    ~1.6e-2, and a 1e-7 relative perturbation of the plain versions' own
    outputs does so in half of the trials, while each kernel call agrees
    with its plain version to ~2e-7 (kernel and plain version sum in
    another order)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.models import attention as A
    from repro_torch.models import ffn as Fm
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    cfg = get_config("vggt-1b-smoke").with_(layerscale_init=0.2)
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = VGGTEngine(cfg, params, policy=PrecisionPlan(default="w4a8", fuse=True),
                     attn_impl="two_stage", batch_buckets=(2,), max_batch=2, pad_patches=True,
                     device=dev)
    scenes = _normal(np.random.default_rng(9), (2, 2, 20, cfg.d_model), dev)
    with probe.tracking() as log:
        got = eng.infer(scenes)
    torch.cuda.synchronize()
    assert log.by_name() == {"fused_matmul": 8, "fused_ffn": 4}
    padded = torch.nn.functional.pad(scenes, (0, 0, 0, 12))
    mask = torch.zeros(padded.shape[:3], dtype=torch.bool, device=dev)
    mask[:, :, :20] = True

    block, worst = vggt._block, [0.0, 0.0]

    def branches(p, x, kv_mask):  # what the block adds to the stream, and its output
        outs, attn, ffn = [], A.gqa_attention, Fm.dense_ffn

        def keep(fn):
            def run(*a, **kw):
                r = fn(*a, **kw)
                outs.append(r[0] if isinstance(r, tuple) else r)  # attention: (out, cache)
                return r
            return run

        A.gqa_attention, Fm.dense_ffn = keep(attn), keep(ffn)
        try:
            y = block(p, eng.cfg, x, kv_mask=kv_mask)
        finally:
            A.gqa_attention, Fm.dense_ffn = attn, ffn
        return outs, y

    def checked(p, cfg_, x, kv_mask=None):
        outs, y = branches(p, x, kv_mask)
        saved = fz.fused_matmul, fz.fused_ffn
        fz.fused_matmul, fz.fused_ffn = fz.fused_matmul_plain, fz.fused_ffn_plain
        try:
            want, _ = branches(p, x, kv_mask)
        finally:
            fz.fused_matmul, fz.fused_ffn = saved
        for j in (0, 1):
            worst[j] = max(worst[j], _rel(outs[j], want[j]))
        return y

    vggt._block = checked
    try:
        with torch.inference_mode():
            direct = vggt.forward(eng.cfg, eng.params, padded, patch_mask=mask)
    finally:
        vggt._block = block
    assert max(worst) < 1e-3, worst
    for k in ("pose", "points", "depth"):
        w = direct[k] if k == "pose" else direct[k][:, :, :20]
        assert torch.isfinite(got[k]).all() and _rel(got[k], w) < 1e-6, (k, _rel(got[k], w))


def test_server_serves_each_tier_through_its_kernels(dev):
    """One request per tier of ``quality=fp,balanced=w4a8,fast=w4a8:fused``
    through ``AsyncServer`` at the smoke width: ``quality`` launches no
    kernel, ``balanced`` the per-site matmul and the two-stage attention,
    ``fast`` the fused projections and FFN and the two-stage attention;
    ``/metrics`` carries the global launch counts."""
    import urllib.request

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import vggt
    from repro_torch.serving.server import AsyncServer
    from repro_torch.serving.vggt_engine import VGGTEngine

    cfg = get_config("vggt-1b-smoke")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = {n: s.materialize() for n, s in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8,fast=w4a8:fused").items()}
    eng = VGGTEngine(cfg, params, tiers=tiers, attn_impl="two_stage", max_batch=2,
                     max_wait_s=0.0, device=dev)
    pairs = cfg.n_layers
    want = {"quality": {},
            "balanced": {"quant_matmul": 12 * pairs, "two_stage_attention": 2 * pairs},
            "fast": {"fused_matmul": 4 * pairs, "fused_ffn": 2 * pairs,
                     "two_stage_attention": 2 * pairs}}
    scenes = _normal(np.random.default_rng(4), (1, 2, 16, cfg.d_model), dev)
    try:
        with AsyncServer(eng, metrics_port=0) as srv:
            for tier in want:
                eng.tier_params(tier)  # quantize outside the counted window
                with probe.tracking() as log:
                    out = srv.result(srv.submit(scenes, tier=tier), timeout=600)
                torch.cuda.synchronize()
                assert log.by_name() == want[tier], (tier, log.by_name())
                assert all(torch.isfinite(out[k]).all() for k in ("pose", "points", "depth"))
            host, port = srv.metrics_address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=60) as r:
                text = r.read().decode()
            counts = probe.global_counters().counts
        for name, n in counts.items():
            assert f'kernel_launches_total{{kernel="{name}"}} {n}' in text
        assert counts["two_stage_attention"] == 4 * pairs
    finally:
        obs.disable_all()


def test_two_stage_mha_takes_strided_single_batch_views(dev):
    """One scene (B = 1): the attention's head-transposed Q/K/V views stay
    strided after the wrapper's reshape; the wrapper hands the kernel
    contiguous operands, and the result is that of contiguous inputs."""
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, (1, 42, 4, 32), dev).movedim(2, 1) for _ in range(3))
    assert not q.reshape(4, 42, 32).is_contiguous()
    with probe.tracking() as log:
        got = ops.two_stage_mha(q, k, v)
    want = ops.two_stage_mha(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert log.by_name() == {"two_stage_attention": 1}
    assert torch.equal(got, want)


def test_tuner_times_the_kernels_on_the_card_and_fills_the_db(dev, tmp_path):
    """The tuner on ``cuda`` times each kernel signature of a fused mixed
    plan (CUDA events, L2 flushed) and persists it; a recompile on the
    filled DB times nothing and yields the same schedule, whose tiles are
    the kernels' launch tiles."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import Autotuner, PrecisionPlan, TuningDB, compile_schedule

    cfg = get_config("vggt-1b-smoke").with_(attn_impl="two_stage")
    plan = PrecisionPlan(default="w4a8", use_kernel=True, fuse=True, name="mixed",
                         overrides=(("frame.attn.wk", "w4a4"), ("global.ffn.w_down", "w8a8")))
    db = str(tmp_path / "tune.json")
    tuner = Autotuner(db=TuningDB(db), device="cuda")
    with probe.tracking() as log:
        sched = compile_schedule(cfg, plan, tuner=tuner)
    assert sched.backend == "cuda" and tuner.timing_runs == len(tuner.db.entries) > 0
    assert all(k.endswith("|cuda") and 0 < e["cost"] < 1e3 for k, e in tuner.db.entries.items())
    kinds = {k.split("|")[0] for k in tuner.db.entries}
    assert kinds == {"quant_matmul", "fused_ffn", "two_stage_mha"}
    assert {"quant_matmul", "fused_matmul", "fused_ffn", "two_stage_attention"} <= set(log.by_name())
    again = Autotuner(db=TuningDB(db), device="cuda")
    assert compile_schedule(cfg, plan, tuner=again).hash == sched.hash
    assert again.timing_runs == 0 and again.db.misses == 0
    for s in sched.sites:
        if s.kernel == "matmul":
            kernel = "fused_matmul" if s.epilogue or s.prologue else "quant_matmul"
            assert dict(s.tiles) == ops.launch_tiles(kernel), s.site


def test_planned_tier_launches_what_its_schedule_says(dev, tmp_path):
    """The planner's fused plan on the card, compiled and served through
    ``VGGTEngine(schedule=path)``: the launches equal the schedule's
    prediction, the outputs the plain versions' forward of the same tree."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import compile_schedule, plan_model
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    cfg = get_config("vggt-1b-smoke")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plan, report = plan_model(cfg, params, use_kernel=True, fuse=True)
    assert sum(report["level_counts"].values()) == 12
    path = str(tmp_path / "s.json")
    compile_schedule(cfg, plan).save(path)
    eng = VGGTEngine(cfg, params, schedule=path, attn_impl="two_stage", max_batch=2, device=dev)
    served = eng.params
    scenes = _normal(np.random.default_rng(6), (2, 2, 16, cfg.d_model), dev)
    with probe.tracking() as log:
        out = eng.infer(scenes)
    torch.cuda.synchronize()
    assert log.by_name() == eng.schedule.launches_per_forward(two_stage_attention=True)
    saved = {n: getattr(m, n) for m, n in ((qm, "quant_matmul"), (tsa, "two_stage_attention"))}
    from repro_torch.kernels import fused as fz

    saved_fz = {n: getattr(fz, n) for n in ("fused_matmul", "fused_ffn")}
    try:
        qm.quant_matmul, tsa.two_stage_attention = qm.quant_matmul_plain, tsa.two_stage_attention_plain
        fz.fused_matmul, fz.fused_ffn = fz.fused_matmul_plain, fz.fused_ffn_plain
        with torch.inference_mode():
            want = vggt.forward(eng.cfg, served, scenes)
    finally:
        qm.quant_matmul, tsa.two_stage_attention = saved["quant_matmul"], saved["two_stage_attention"]
        fz.fused_matmul, fz.fused_ffn = saved_fz["fused_matmul"], saved_fz["fused_ffn"]
    for k in ("pose", "points", "depth"):
        rel = ((out[k] - want[k]).norm() / want[k].norm()).item()
        assert torch.isfinite(out[k]).all() and rel < 1e-3, (k, rel)


@pytest.mark.parametrize("fuse", [False, True])
def test_lm_smoke_forward_matches_plain(dev, monkeypatch, fuse):
    """qwen3-14b-smoke's W4A8 tree on the card, unfused (``quant_matmul``)
    and fused (``fused_matmul`` with the RMS prologue for ``wqkv``,
    ``fused_ffn`` with the SiLU gate), over a full-mode forward through the
    two-stage kernel and a left-padded prefill + 2 decode steps.  Every
    layer's attention and FFN branch, fed the same input, against the plain
    versions (rel L2 1e-3 over all calls of a branch kind, the bound of
    the card's fused checks: a decode call has 2 rows, and one hidden
    rounding flipped by the kernel's summation order moves such a call by
    ~1.5e-3 at this width); the logits within 2e-2: one int8 activation
    rounding that the kernels' other summation order flips moves its
    token's logits by up to ~1e-2 at this width, as the cross-framework
    tests measure (tests/test_torch_lm.py, REL_L2_FLIP)."""
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.kernels import fused as fz
    from repro_torch.models import attention as A
    from repro_torch.models import ffn as Fm
    from repro_torch.models import lm

    cfg = get_config("qwen3-14b-smoke").with_(attn_impl="two_stage")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        qp = quantize_lm(cfg, params, PrecisionPlan(default="w4a8", use_kernel=True, fuse=fuse))
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24)),
                           device=dev)
    pad = torch.tensor([0, 5], device=dev)
    kernels = [(qm, "quant_matmul"), (tsa, "two_stage_attention"), (fz, "fused_matmul"),
               (fz, "fused_ffn")]
    saved = [getattr(m, n) for m, n in kernels]

    def plain(on):
        for (m, n), fn in zip(kernels, saved):
            setattr(m, n, getattr(m, f"{n}_plain") if on else fn)

    sums = [[0.0, 0.0], [0.0, 0.0]]  # per kind: squared difference, squared reference

    def checked(j, fn):  # the branch with the kernels, then with the plain versions
        def run(*a, **kw):
            r = fn(*a, **kw)
            plain(True)
            try:
                w = fn(*a, **kw)
            finally:
                plain(False)
            got, want = (r[0], w[0]) if j == 0 else (r, w)
            sums[j][0] += ((got.double() - want.double()) ** 2).sum().item()
            sums[j][1] += (want.double() ** 2).sum().item()
            return r
        return run

    def run():
        with torch.inference_mode():
            full, _ = lm.forward(cfg, qp, toks)
            cache = lm.init_cache(cfg, 2, 32, device=dev)
            pre, cache = lm.forward(cfg, qp, toks[:, :20], cache=cache, mode="prefill",
                                    pad_lens=pad)
            outs = [full, pre[:, -1]]
            for t in (20, 21):
                step, cache = lm.decode_step(cfg, qp, toks[:, t], cache, pad_lens=pad)
                outs.append(step[:, 0])
        return outs

    with probe.tracking() as log:
        got = run()
    torch.cuda.synchronize()
    n = cfg.n_layers
    want_launches = ({"fused_matmul": 2 * n * 4, "fused_ffn": n * 4, "two_stage_attention": n}
                     if fuse else {"quant_matmul": 7 * n * 4, "two_stage_attention": n})
    assert log.by_name() == want_launches
    monkeypatch.setattr(A, "gqa_attention", checked(0, A.gqa_attention))
    monkeypatch.setattr(Fm, "dense_ffn", checked(1, Fm.dense_ffn))
    run()
    pooled = [(d / r) ** 0.5 for d, r in sums]
    assert max(pooled) < 1e-3, pooled
    monkeypatch.undo()
    plain(True)
    try:
        want = run()
    finally:
        plain(False)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel(g, w) < 2e-2, _rel(g, w)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 7168), (7168, 2048)])
def test_quant_matmul_rwkv6_shapes(dev, m, k, n):
    """rwkv6-1.6b's W4 projections at decode's slot widths: the time-mix
    (2048 x 2048), the channel-mix up (2048 x 7168) and down (7168 x 2048)."""
    rng = np.random.default_rng(m * 7 + k + n)
    xq = quantize_per_token(_normal(rng, (m, k), dev), 8)
    wq = quantize_weight(_normal(rng, (k, n), dev), 4)
    ws = wq.scale.reshape(1, -1)
    with probe.tracking() as log:
        got = qm.quant_matmul(xq.values, xq.scale, wq.values, ws, packed=True)
    torch.cuda.synchronize()
    want = qm.quant_matmul_plain(xq.values, xq.scale, wq.values, ws, packed=True)
    assert log.by_name() == {"quant_matmul": 1}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _lm_serving_script(eng, prompts, n_steps):
    """Two requests, then the rest while they decode; returns their ids."""
    import time

    reqs = [eng.enqueue(p, n_steps) for p in prompts[:2]]
    time.sleep(2 * eng.max_wait_s)
    eng.poll()
    assert eng.active == 2
    reqs += [eng.enqueue(p, n_steps) for p in prompts[2:]]
    eng.flush()
    return [r.result() for r in reqs]


@pytest.mark.parametrize("arch,policy", [("qwen3-14b-smoke", "fp"), ("qwen3-14b-smoke", "w4a8"),
                                         ("rwkv6-1.6b-smoke", "fp"), ("rwkv6-1.6b-smoke", "w4a8")])
def test_continuous_matches_bucket_on_the_card(dev, arch, policy):
    """The continuous scheduler on the card at smoke width (``DecodeRunner``
    for qwen3, ``StateDecodeRunner`` for rwkv6): requests join mid-decode,
    the W4A8 tier launches 7 ``quant_matmul`` a layer per prefill wave and
    decode step (the fp tier none), and the ids equal bucket mode's."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeRunner, Engine, StateDecodeRunner

    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    pol = None if policy == "fp" else PrecisionPlan(default="w4a8", use_kernel=True)
    rng = np.random.default_rng(3)
    lens = (16, 12, 9, 16) if arch.startswith("qwen") else (16, 12, 9, 7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]
    eng = Engine(cfg, params, policy=pol, max_len=64, max_batch=8, decode_steps_per_poll=4,
                 device="cuda")
    with probe.tracking() as log:
        got = _lm_serving_script(eng, prompts, 12)
    runner = eng._sched.runner("default")
    assert isinstance(runner, StateDecodeRunner if arch.startswith("rwkv") else DecodeRunner)
    assert eng.stats.scheduler.admitted_mid_decode >= 2  # rwkv's 2nd length joins too
    calls = sum(s.calls for s in eng.stats.buckets.values())  # prefill waves + decode steps
    assert log.by_name() == ({} if pol is None else {"quant_matmul": 7 * cfg.n_layers * calls})
    ref = Engine(cfg, params, policy=pol, max_len=64, mode="bucket", device="cuda")
    for p, ids in zip(prompts, got):
        np.testing.assert_array_equal(ids, ref.generate(p[None], 12)[0])


# ---------------------------------------------------------------------------
# quant_matmul's batched launch (a MoE layer's routed experts)
# ---------------------------------------------------------------------------


def _stacked(rng, b, e, m, k, n, packed, dev):
    """B problems' quantized rows over E quantized expert weights."""
    xq = quantize_per_token(_normal(rng, (b, m, k), dev), 8)
    ws, wv = [], []
    for _ in range(e):
        wq = quantize_weight(_normal(rng, (k, n), dev), 4 if packed else 8)
        wv.append(wq.values)
        ws.append(wq.scale.reshape(1, -1))
    return xq.values, xq.scale, torch.stack(wv), torch.stack(ws)


# deepseek-moe-16b's routed experts at W4 (E 64; gate/up K 2048 x N 1408,
# down K 1408 x N 2048) at a 2 x 512 prefill's capacity (M 120) and
# decode's (M 1); two dispatch blocks sharing three experts' weights; W8;
# ragged M and N tiles, N % 16 != 0 and a partial K step.
@pytest.mark.parametrize("packed,b,e,m,k,n", [
    (True, 64, 64, 120, 2048, 1408), (True, 64, 64, 120, 1408, 2048),
    (True, 64, 64, 1, 2048, 1408), (True, 64, 64, 1, 1408, 2048),
    (True, 6, 3, 130, 256, 260), (False, 8, 8, 37, 128, 132), (False, 4, 2, 129, 96, 388),
    (True, 5, 5, 65, 96, 64),
])
def test_quant_matmul_batched_matches_plain(dev, packed, b, e, m, k, n):
    rng = np.random.default_rng(b + e + m + k + n)
    xv, xs, wv, ws = _stacked(rng, b, e, m, k, n, packed, dev)
    with probe.tracking() as log:
        got = qm.quant_matmul_batched(xv, xs, wv, ws, packed=packed)
    torch.cuda.synchronize()
    assert log.by_name() == {"quant_matmul_batched": 1}
    want = qm.quant_matmul_batched_plain(xv, xs, wv, ws, packed=packed)
    # the integer part is exact; only the two float scale multiplies round
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # each problem is bit for bit the 2-D launch on its slice
    for i in sorted({0, b // 2, b - 1}):
        one = qm.quant_matmul(xv[i], xs[i], wv[i % e], ws[i % e], packed=packed)
        assert torch.equal(got[i], one), i


def test_quant_linear_matmul_expert_stacked_is_one_launch(dev):
    """``ops.quant_linear_matmul`` on an expert-stacked weight and x of two
    dispatch blocks [2, E, cap, K]: one batched launch, the plain result."""
    from repro_torch.core.quantize import QTensor

    rng = np.random.default_rng(3)
    e, cap, k, n = 8, 5, 128, 64
    wqs = [quantize_weight(_normal(rng, (k, n), dev), 4) for _ in range(e)]
    wq = QTensor(values=torch.stack([w.values for w in wqs]),
                 scale=torch.stack([w.scale for w in wqs]), bits=4, packed=True, pack_axis=0)
    x = _normal(rng, (2, e, cap, k), dev)
    with probe.tracking() as log:
        got = ops.quant_linear_matmul(x, wq)
    torch.cuda.synchronize()
    assert log.by_name() == {"quant_matmul_batched": 1} and got.shape == (2, e, cap, n)
    xq = quantize_per_token(x, 8)
    for blk in range(2):
        for j in range(e):
            want = qm.quant_matmul_plain(xq.values[blk, j], xq.scale[blk, j], wqs[j].values,
                                         wqs[j].scale.reshape(1, -1), packed=True)
            torch.testing.assert_close(got[blk, j], want, rtol=1e-6, atol=0)


def test_quant_matmul_batched_rejects_bad_shapes(dev):
    xv = torch.zeros((6, 4, 64), dtype=torch.int8, device=dev)
    xs = torch.ones((6, 4, 1), device=dev)
    wv = torch.zeros((4, 32, 8), dtype=torch.uint8, device=dev)
    ws = torch.ones((4, 1, 8), device=dev)
    with probe.tracking() as log:
        with pytest.raises(ValueError, match="E must divide B"):
            qm.quant_matmul_batched(xv, xs, wv, ws, packed=True)  # 6 problems over 4 experts
        k = 1 << 17
        with pytest.raises(ValueError, match="2\\^17"):
            qm.quant_matmul_batched(torch.zeros((1, 1, k), dtype=torch.int8, device=dev),
                                    torch.ones((1, 1, 1), device=dev),
                                    torch.zeros((1, k // 2, 4), dtype=torch.uint8, device=dev),
                                    torch.ones((1, 1, 4), device=dev), packed=True)
    assert log.count == 0


# ---------------------------------------------------------------------------
# LM schedules: the compiler's LM lowering served on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 1024])
@pytest.mark.parametrize("site", ["wqkv", "wo"])
def test_fused_matmul_at_deepseek_sites(dev, site, m):
    """deepseek-moe-16b's fused sites under ``w4a8:fused`` (its W4 QKV
    panel, 2048 x 6144 / 2, is under the 8 MiB budget): ``wqkv`` with the
    RMS norm absorbed and ``wo`` with its epilogue, W4A8 with the IDCT and
    no bias, at decode's M = 1 and 4 and a 2 x 512 prefill wave's 1024."""
    n, norm = (6144, "rms") if site == "wqkv" else (2048, None)
    test_fused_matmul_matches_plain(
        dev, (m, 2048, n, 4, 8, norm, False, "none", False, None, True, False, False))


def test_tuner_times_the_batched_expert_launch(dev, tmp_path):
    """A MoE schedule compiled with the tuner on the card: the routed
    experts' signature times the batched launch, and a recompile on the
    filled DB times nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import Autotuner, PrecisionPlan, TuningDB, compile_schedule
    from repro_torch.core.precision import tuner as ttuner

    cfg = get_config("deepseek-moe-16b-smoke")
    plan = PrecisionPlan(default="w4a8", use_kernel=True, fuse=True)
    db = str(tmp_path / "tune.json")
    t1 = Autotuner(db=TuningDB(db), device="cuda")
    s1 = compile_schedule(cfg, plan, tuner=t1)
    key = ttuner.batched_key(cfg.d_model, cfg.moe_d_ff, experts=cfg.n_experts, w_bits=4,
                             a_bits=8, packed=True, backend="cuda")
    assert 0.0 < t1.db.entries[key]["cost"] < 100.0
    t2 = Autotuner(db=TuningDB(db), device="cuda")
    assert compile_schedule(cfg, plan, tuner=t2).hash == s1.hash and t2.timing_runs == 0


@pytest.mark.parametrize("arch", ["qwen3-14b-smoke", "rwkv6-1.6b-smoke", "deepseek-moe-16b-smoke"])
def test_lm_schedule_launches_what_it_predicts(dev, tmp_path, arch):
    """A ``w4a8:fused`` schedule served through ``Engine(schedule=path)``
    on the card, requests joining mid-decode: every prefill wave and decode
    step launches what ``launches_per_forward(two_stage_attention=False)``
    predicts (``fused_matmul``/``fused_ffn`` where the smoke widths fuse,
    the batched launch for deepseek's routed experts), and the ids equal
    the same plan served as a policy."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPlan, compile_schedule
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plan = PrecisionPlan(default="w4a8", use_kernel=True, fuse=True, name="w4a8")
    sched = compile_schedule(cfg, plan)
    path = str(tmp_path / "s.json")
    sched.save(path)
    want = sched.launches_per_forward(two_stage_attention=False)
    rng = np.random.default_rng(4)
    lens = (16, 12, 9, 16) if arch.startswith(("qwen", "deepseek")) else (16, 12, 9, 7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lens]
    eng = Engine(cfg, params, schedule=path, max_len=64, max_batch=8, decode_steps_per_poll=4,
                 device="cuda")
    eng.params
    calls = []
    fwd = lm.forward

    def counted(*a, **kw):
        with probe.tracking() as log:
            out = fwd(*a, **kw)
        calls.append((kw.get("mode"), log.by_name()))
        return out

    lm.forward = counted
    try:
        got = _lm_serving_script(eng, prompts, 12)
    finally:
        lm.forward = fwd
    torch.cuda.synchronize()
    assert {mode for mode, _ in calls} == {"prefill", "decode"}
    assert all(log == want for _, log in calls), (want, calls)
    if cfg.moe:
        assert want["quant_matmul_batched"] == 3 * (cfg.n_layers - cfg.first_dense)
    ref = Engine(cfg, params, policy=plan, max_len=64, max_batch=8, decode_steps_per_poll=4,
                 device="cuda")
    for g, r in zip(got, _lm_serving_script(ref, prompts, 12)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "paligemma-3b"])
def test_full_width_two_layer_forward_matches_plain(dev, monkeypatch, arch):
    """phi3-mini-3.8b (MHA 32/32, dh 96) and paligemma-3b (MQA 8/1, dh 256,
    GeGLU, embedding inputs) at full width, cut to 2 layers, seed-0
    weights: a W4A8 ``mode="full"`` forward with two-stage attention
    launches 7 ``quant_matmul`` and one two-stage kernel a layer, and every
    layer's attention and FFN branch, fed the same input, is within rel L2
    3e-4 of the plain versions' (the kernel's bound against its plain
    version); the logits within the quantized flip bound 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.models import attention as A
    from repro_torch.models import ffn as Fm
    from repro_torch.models import lm

    cfg = get_config(arch).with_(n_layers=2, attn_impl="two_stage")
    with torch.inference_mode():
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        qp = quantize_lm(cfg, params, PrecisionPlan(default="w4a8", use_kernel=True))
    del params
    rng = np.random.default_rng(9)
    x = (torch.as_tensor(rng.normal(size=(1, 300, cfg.d_model)).astype(np.float32), device=dev)
         if cfg.embed_inputs else
         torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 300)), device=dev))
    kernels = [(qm, "quant_matmul"), (tsa, "two_stage_attention")]
    saved = [getattr(m, n) for m, n in kernels]

    def plain(on):
        for (m, n), fn in zip(kernels, saved):
            setattr(m, n, getattr(m, f"{n}_plain") if on else fn)

    rels = {0: [], 1: []}

    def checked(j, fn):
        def run(*a, **kw):
            r = fn(*a, **kw)
            plain(True)
            try:
                w = fn(*a, **kw)
            finally:
                plain(False)
            got, want = (r[0], w[0]) if j == 0 else (r, w)
            rels[j].append(_rel(got, want))
            return r
        return run

    with torch.inference_mode(), probe.tracking() as log:
        got, _ = lm.forward(cfg, qp, x)
    torch.cuda.synchronize()
    assert log.by_name() == {"quant_matmul": 7 * 2, "two_stage_attention": 2}
    monkeypatch.setattr(A, "gqa_attention", checked(0, A.gqa_attention))
    monkeypatch.setattr(Fm, "dense_ffn", checked(1, Fm.dense_ffn))
    with torch.inference_mode():
        lm.forward(cfg, qp, x)
    monkeypatch.undo()
    assert len(rels[0]) == len(rels[1]) == 2
    assert max(rels[0] + rels[1]) < 3e-4, rels
    plain(True)
    try:
        with torch.inference_mode():
            want, _ = lm.forward(cfg, qp, x)
    finally:
        plain(False)
    assert torch.isfinite(got).all() and _rel(got, want) < 2e-2, _rel(got, want)


@pytest.mark.parametrize("m", [1, 4, 1024])
@pytest.mark.parametrize("site,k,n", [("wq", 2048, 3072), ("w_kv_down", 2048, 576),
                                      ("w_k_up", 512, 2048), ("w_v_up", 512, 2048)])
def test_quant_matmul_mla_sites(dev, site, k, n, m):
    """deepseek-v2-lite-16b's W4 MLA sites at decode's M 1 and 4 and a
    1024-row prefill: ``w_kv_down``'s N 576 ends in a 64-column part of a
    256-column tile, the up-projections run K 512 (8 K steps)."""
    rng = np.random.default_rng(m * 11 + k + n + len(site))
    xq = quantize_per_token(_normal(rng, (m, k), dev), 8)
    wq = quantize_weight(_normal(rng, (k, n), dev), 4)
    ws = wq.scale.reshape(1, -1)
    with probe.tracking() as log:
        got = qm.quant_matmul(xq.values, xq.scale, wq.values, ws, packed=True)
    torch.cuda.synchronize()
    want = qm.quant_matmul_plain(xq.values, xq.scale, wq.values, ws, packed=True)
    assert log.by_name() == {"quant_matmul": 1} and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("policy", ["fp", "w4a8"])
def test_mla_absorbed_decode_on_the_card_matches_cpu(dev, policy):
    """One MLA layer of ``deepseek-v2-lite-16b-smoke`` (seed-0 weights; W4A8
    on ``quant_matmul``): a left-padded prefill on the CPU, then one
    absorbed decode step from that cache on the CPU (the plain versions)
    and on the card (the kernel at wq, w_kv_down and wo; the
    up-projections read dequantized): outputs within 1e-5, the written
    compressed row within one step on at most one entry."""
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.tree import to_device, tree_index

    cfg = get_config("deepseek-v2-lite-16b-smoke")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    if policy == "w4a8":
        params = quantize_lm(cfg, params, PrecisionPlan(default="w4a8", use_kernel=True))
    mixer = tree_index(params["blocks"]["l0"], 0)["mixer"]
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32))
    pad = torch.tensor([0, 3])
    pos = torch.clamp_min(torch.arange(9)[None, :] - pad[:, None], 0)
    cache = A.init_kv_cache(cfg, 2, 16, 1)
    cache = cache._replace(k=cache.k[0], v=cache.v[0], k_scale=cache.k_scale[0],
                           v_scale=cache.v_scale[0])
    with torch.inference_mode():
        _, cache = A.mla_attention(mixer, cfg, x[:, :8], positions=pos[:, :8], cache=cache,
                                   mode="prefill", pad_lens=pad)
        card = cache._replace(**{f: getattr(cache, f).to(dev)
                                 for f in ("k", "v", "k_scale", "v_scale")})
        want, cpu_c = A.mla_attention(mixer, cfg, x[:, 8:], positions=pos[:, 8:], cache=cache,
                                      mode="decode", pad_lens=pad)
        with probe.tracking() as log:
            got, card_c = A.mla_attention(to_device(mixer, dev), cfg, x[:, 8:].to(dev),
                                          positions=pos[:, 8:].to(dev), cache=card,
                                          mode="decode", pad_lens=pad.to(dev))
        torch.cuda.synchronize()
    assert log.by_name() == ({"quant_matmul": 3} if policy == "w4a8" else {})
    assert card_c.length == cpu_c.length == 9
    assert _rel(got.cpu(), want) < 1e-5, _rel(got.cpu(), want)
    d = (card_c.k.cpu().to(torch.int32) - cpu_c.k.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1


# One train step (``runtime.trainer.make_train_step``: autograd, then AdamW
# in place) on the card against the same step on the CPU, from the same
# weights and batch, TF32 off: the loss and every updated leaf, at the
# bounds of tests/test_torch_train.py's parity with the JAX package.
@pytest.mark.parametrize("arch", ["qwen3-14b-smoke", "vggt-1b-smoke"])
def test_train_step_on_the_card_matches_cpu(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, scene_batch, token_batch
    from repro_torch.models import lm, vggt
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import make_train_step
    from repro_torch.tree import tree_map, tree_paths

    cfg = get_config(arch)
    if cfg.vggt:
        cpu = vggt.init_params(cfg, torch.Generator().manual_seed(0))
        batch = scene_batch(2, 2, 16, cfg.d_model, 3)
        loss_fn = lambda p, b: vggt.reconstruction_loss(cfg, p, b)  # noqa: E731
    else:
        cpu = lm.init_params(cfg, torch.Generator().manual_seed(0))
        batch = token_batch(DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=16), 3)
        loss_fn = None
    card = tree_map(lambda x: x.to(dev, copy=True), cpu)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                           loss_fn)
    cpu, _, m_cpu = step(cpu, adamw.init(cpu), batch)
    card, _, m_card = step(card, adamw.init(card), batch)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-5 * abs(float(m_cpu["loss"]))
    want = tree_paths(cpu)
    for path, x in tree_paths(card).items():
        w = want[path].double()
        rel = float((x.cpu().double() - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= 1e-4, (path, rel)


# ---------------------------------------------------------------------------
# the multi-device layer at world size 1 over NCCL (one card: NCCL refuses
# two ranks on one device, so N > 1 runs on CPU gloo ranks, in
# tests/test_torch_{sharding,compression,pipeline}.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh(dev, tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    init = tmp_path_factory.mktemp("nccl") / "pg"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_local_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_nccl_group_of_one(nccl_mesh):
    import torch.distributed as dist

    assert tuple(nccl_mesh.shape) == (1, 1)
    assert nccl_mesh.mesh_dim_names == ("data", "model")
    x = torch.arange(8.0, device="cuda")
    dist.all_reduce(x, group=nccl_mesh.get_group("model"))
    assert torch.equal(x, torch.arange(8.0, device="cuda"))


def test_sharded_w4a8_forward_is_bit_equal_to_the_unsharded(dev, nccl_mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.core.precision import PrecisionPlan
    from repro_torch.models import lm
    from repro_torch.parallel import sharding

    cfg = get_config("qwen3-14b-smoke").with_(attn_impl="two_stage")
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = quantize_lm(cfg, raw, PrecisionPlan(default="w4a8", use_kernel=True))
    toks = torch.randint(0, cfg.vocab_size, (4, 32), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad(), probe.tracking() as log1:
        want, _ = lm.forward(cfg, params, toks)
    sharded = sharding.distribute_tree(params, nccl_mesh)
    stoks = sharding.distribute_tree(toks, nccl_mesh,
                                     lambda p, x: (sharding.batch_axes(nccl_mesh), None))
    with torch.no_grad(), implicit_replication(), probe.tracking() as log2:
        got, _ = lm.forward(cfg, sharded, stoks)
    assert log1.by_name() == log2.by_name() == {"quant_matmul": 7 * cfg.n_layers,
                                                "two_stage_attention": cfg.n_layers}
    assert torch.equal(got.full_tensor(), want)


def test_compressed_psum_at_world_one_is_its_formula(nccl_mesh):
    from repro_torch.parallel.compression import compressed_psum

    rng = np.random.default_rng(7)
    g = _normal(rng, (4099,), "cuda")
    err = _normal(rng, (4099,), "cuda") * 1e-3
    out, new_err = compressed_psum(g, nccl_mesh.get_group("data"), 1, err)
    gf = g + err
    s = torch.clamp_min(gf.abs().max() * float(torch.tensor(1 / 127.0)), 1e-20)
    q = torch.clamp(torch.round(gf / s), -127, 127)
    r = torch.clamp_min(q.abs().max() * float(torch.tensor(1 / 127.0)), 1.0)
    q2 = torch.clamp(torch.round(q / r), -127, 127)
    assert torch.equal(out, q2 * (r * s))
    assert torch.equal(new_err, torch.addcmul(gf, q, s.expand_as(gf), value=-1.0))


def test_pipeline_at_one_stage_is_the_stage(nccl_mesh):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    rng = np.random.default_rng(8)
    w = _normal(rng, (1, 64, 64), "cuda") * 0.1
    x = _normal(rng, (8, 64), "cuda")
    got = pipeline_apply(mesh, lambda p, h: torch.tanh(h @ p), w, x, n_micro=4)
    assert torch.equal(got, torch.cat([torch.tanh(xm @ w[0]) for xm in x.reshape(4, 2, 64)]))


@pytest.mark.parametrize("m", [2, 4, 16])
def test_tensor_parallel_sites_on_local_shards_at_qwen3_14b_widths(dev, m):
    """The kernels at the shapes an ``m``-way model axis hands each rank, with
    no process group (the card's NCCL mesh is 1 x 1, whose shards are whole):
    every rank's slice of qwen3-14b's W4 weights, contiguous as DTensor's
    local shards are, for 1024 tokens ([2, 512]).

    Column-parallel ``wq``/``w_up``: each rank's N/m columns, concatenated,
    equal the unsharded launch bit for bit.  Row-parallel ``wo``/``w_down``:
    each rank's K/2m packed rows through ``sites.row_partial`` (its two
    nibble runs of K) equal the plain version on the same local operands to
    the kernel's own 1e-6, and their sum the unsharded launch (float partial
    sums added in rank order).  Two-stage attention on each rank's heads,
    where ``m`` divides both head counts (40 and 8; else the site runs
    replicated), equals the unsharded launch bit for bit."""
    import dataclasses

    from repro_torch.parallel import sites

    d, heads, kv_heads, dh, ff, tokens = 5120, 40, 8, 128, 17408, 1024
    rng = np.random.default_rng(m)
    for k, n, row in ((d, heads * dh, False), (d, ff, False), (heads * dh, d, True),
                      (ff, d, True)):
        x = _normal(rng, (tokens, k), dev)
        wq = quantize_weight(_normal(rng, (k, n), dev) * 0.02, 4)
        with probe.tracking() as log:
            whole = ops.quant_linear_matmul(x, wq)
            parts = []
            for r in range(m):
                if row:
                    rows = k // (2 * m)
                    local = dataclasses.replace(wq, values=wq.values[r * rows:(r + 1) * rows]
                                                .contiguous())
                    parts.append(sites.row_partial(x, local, r, m))
                else:
                    cols = slice(r * n // m, (r + 1) * n // m)
                    local = dataclasses.replace(wq, values=wq.values[:, cols].contiguous(),
                                                scale=wq.scale[..., cols].contiguous())
                    parts.append(ops.quant_linear_matmul(x, local))
        torch.cuda.synchronize()
        assert log.by_name() == {"quant_matmul": 1 + m}, (k, n)
        xq = quantize_per_token(x, 8)
        torch.testing.assert_close(whole, qm.quant_matmul_plain(
            xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1), packed=True),
            rtol=1e-6, atol=0)
        if not row:
            assert torch.equal(torch.cat(parts, dim=-1), whole), (k, n)
            continue
        for r, part in enumerate(parts):
            rows = k // (2 * m)
            idx = sites.row_columns(k, rows, r, packed=True, device=dev)
            want = qm.quant_matmul_plain(xq.values.index_select(1, idx), xq.scale,
                                         wq.values[r * rows:(r + 1) * rows].contiguous(),
                                         wq.scale.reshape(1, -1), packed=True)
            torch.testing.assert_close(part, want, rtol=1e-6, atol=0)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        torch.testing.assert_close(total, whole, rtol=1e-5,
                                   atol=1e-5 * float(whole.abs().max()))
    if heads % m or kv_heads % m:
        return
    q = _normal(rng, (2, heads, 512, dh), dev)
    kk, v = (_normal(rng, (2, kv_heads, 512, dh), dev) for _ in range(2))
    with probe.tracking() as log:
        whole = ops.two_stage_mha(q, kk, v, causal=True)
        parts = [ops.two_stage_mha(*(t[:, r * t.shape[1] // m:(r + 1) * t.shape[1] // m]
                                     .contiguous() for t in (q, kk, v)), causal=True)
                 for r in range(m)]
    torch.cuda.synchronize()
    assert log.by_name() == {"two_stage_attention": 1 + m}
    assert torch.equal(torch.cat(parts, dim=1), whole)
