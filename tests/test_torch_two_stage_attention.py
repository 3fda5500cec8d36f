"""Two-stage INT8 attention of the PyTorch port (its plain version, which
CPU tensors take) vs the JAX Pallas kernel in interpret mode, its jnp
oracle, and the reference wrapper ``ops.two_stage_mha``.

Tolerance 3e-4, the reference kernel test's own
(``tests/kernels/test_two_stage_attention.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_per_token as j_qpt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.two_stage_attention import two_stage_attention as j_tsa
from repro_torch.kernels import ops, probe
from repro_torch.kernels import two_stage_attention as tsa

RNG = np.random.default_rng(3)
TOL = dict(rtol=3e-4, atol=3e-4)


def _f(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _quant_both(q, k, v):
    """The same int8 operands for both packages (the reference test's
    recipe: per-token Q/K, per-head V)."""
    jq, jk = j_qpt(jnp.asarray(q), 8), j_qpt(jnp.asarray(k), 8)
    vs = jnp.max(jnp.abs(jnp.asarray(v)), axis=(1, 2), keepdims=True) / 127.0
    vv = jnp.clip(jnp.round(jnp.asarray(v) / vs), -127, 127).astype(jnp.int8)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    return (jq, jk, vv, vs), (t(jq.values), t(jq.scale), t(jk.values), t(jk.scale), t(vv), t(vs))


@pytest.mark.parametrize(
    "bh,bhkv,l,dh,causal,bq,bk,bkv",
    [
        (2, 2, 128, 64, False, 64, 64, 128),  # non-causal, several tiles
        (2, 2, 128, 32, True, 32, 32, 64),  # causal at Lq == Lk
        (4, 2, 96, 32, False, 32, 32, 96),  # GQA (4 query heads over 2 K/V heads)
        (4, 1, 64, 64, True, 64, 64, 64),  # GQA (4, 1), causal
        (2, 2, 64, 128, False, 32, 32, 64),  # head dim 128 (qwen3-14b)
        (5, 1, 64, 128, True, 32, 32, 64),  # dh 128, GQA (5, 1) as 40/8, causal
        (2, 2, 72, 96, False, 24, 24, 72),  # head dim 96 (phi3-mini-3.8b), MHA, ragged L
        (2, 2, 72, 96, True, 24, 24, 72),  # dh 96, causal at Lq == Lk, ragged L
        (8, 1, 64, 256, True, 32, 32, 64),  # head dim 256 (paligemma-3b), MQA (8, 1), causal
    ],
)
def test_plain_matches_pallas_kernel(bh, bhkv, l, dh, causal, bq, bk, bkv):
    q, k, v = _f(bh, l, dh), _f(bhkv, l, dh), _f(bhkv, l, dh)
    (jq, jk, jvv, jvs), (tq, tqs, tk, tks, tvv, tvs) = _quant_both(q, k, v)
    g = bh // bhkv
    vs_q = jnp.repeat(jvs, g, axis=0)  # v_scale stays per query head
    gqa = dict(q_heads=bh, kv_heads=bhkv) if bh != bhkv else {}
    want = j_tsa(jq.values, jq.scale, jk.values, jk.scale, jvv, vs_q, causal=causal,
                 bq=bq, bk=bk, bkv=bkv, interpret=True, **gqa)
    with probe.tracking() as log:
        got = tsa.two_stage_attention(tq, tqs, tk, tks, tvv, torch.as_tensor(np.asarray(vs_q)),
                                      causal=causal, **gqa)
    assert log.count == 0  # CPU tensors take the plain version: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if bh == bhkv:  # the integer oracle (bottom-right causal == top-left at Lq == Lk)
        oracle = jref.two_stage_attention_ref(jq.values, jq.scale, jk.values, jk.scale, jvv, jvs,
                                              causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("h,hkv,causal", [(4, 4, False), (4, 2, False), (4, 4, True)])
def test_two_stage_mha_lane_padded_odd_length(h, hkv, causal):
    """L=42 is no multiple of the TPU's 8-row lanes: the reference wrapper
    pads to 48 and masks the tail keys; the port never pads."""
    b, l, dh = 2, 42, 32
    q, k, v = _f(b, h, l, dh), _f(b, hkv, l, dh), _f(b, hkv, l, dh)
    want = jops.two_stage_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              interpret=True)
    got = ops.two_stage_mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            causal=causal)
    assert tuple(got.shape) == (b, h, l, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_keeps_per_head_scales_and_close_to_fp():
    """Sanity against float attention: int8 Q/K/V plus int8 probabilities
    stay within 5% relative L2 (the reference test's bound)."""
    q, k, v = _f(1, 2, 128, 64), _f(1, 2, 128, 64), _f(1, 2, 128, 64)
    v[0, 1] *= 10.0  # per-head V scales must not leak across heads
    got = ops.two_stage_mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v)).numpy()
    fp = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=False))
    for hh in range(2):
        rel = np.linalg.norm(got[0, hh] - fp[0, hh]) / np.linalg.norm(fp[0, hh])
        assert rel < 0.05, (hh, rel)

