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


# K=96 ends in a partial K step (W4: 48 packed rows of a 32-row step), K=48
# too (W8 only: packing needs K % 32 == 0); N=132/260 end in a partial N
# tile, M=1/37/129/130 in a partial M tile
@pytest.mark.parametrize(
    "packed,m,k,n",
    [(p, *s) for p in (False, True) for s in _MM_SHAPES] + [(False, 65, 48, 36)],
)
def test_quant_matmul_matches_plain(dev, packed, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = _normal(rng, (m, k), dev)
    wq = quantize_weight(_normal(rng, (k, n), dev), 4 if packed else 8)
    xq = quantize_per_token(x, 8)
    ws = wq.scale.reshape(1, -1)
    with probe.tracking() as log:
        got = qm.quant_matmul(xq.values, xq.scale, wq.values, ws, packed=packed)
    torch.cuda.synchronize()
    want = qm.quant_matmul_plain(xq.values, xq.scale, wq.values, ws, packed=packed)
    assert log.by_name() == {"quant_matmul": 1}
    # the integer part is exact; only the two float scale multiplies round
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_quant_matmul_rejects_bad_k(dev):
    xq = quantize_per_token(torch.ones(4, 24, device=dev), 8)
    wq = quantize_weight(torch.ones(24, 8, device=dev), 8)
    with pytest.raises(ValueError):
        qm.quant_matmul(xq.values, xq.scale, wq.values, wq.scale, packed=False)


@pytest.mark.parametrize(
    "b,h,hkv,lq,lk,dh,causal",
    [
        (1, 2, 2, 64, 64, 64, False),
        (2, 4, 4, 42, 42, 32, False),
        (1, 4, 4, 200, 200, 64, True),
        (1, 4, 2, 130, 130, 64, False),
        (1, 4, 1, 77, 77, 64, True),
        (1, 2, 2, 40, 2100, 64, False),
    ],
)
def test_two_stage_matches_plain(dev, b, h, hkv, lq, lk, dh, causal):
    rng = np.random.default_rng(lq * 7 + lk + dh)
    q = _normal(rng, (b, h, lq, dh), dev)
    k = _normal(rng, (b, hkv, lk, dh), dev)
    v = _normal(rng, (b, hkv, lk, dh), dev)
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
    torch.testing.assert_close(got.reshape(b * h, lq, dh), want, rtol=3e-4, atol=3e-4)
