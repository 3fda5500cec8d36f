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


# The kernel runs 128 x 128 output tiles, each of two 64-row warpgroups,
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
                outs.append(fn(*a, **kw))
                return outs[-1]
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
