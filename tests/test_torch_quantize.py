"""PyTorch port vs the JAX package: transforms, quantization primitives and
the VersaQ weight flow (``repro_torch.core`` vs ``repro.core``).

Integer values must match exactly and scales to rtol 1e-6: both sides
round half-to-even, divide by the scale and floor amax at 1e-8.  Float
transforms that are pure add/sub butterflies match bit for bit; those that
go through a matmul match to float32 summation-order noise (rtol 1e-6).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# ``repro.core`` and ``repro_torch.core`` re-export a ``quantize`` function
# that shadows the module
jqz = importlib.import_module("repro.core.quantize")
jtr = importlib.import_module("repro.core.transforms")
jvq = importlib.import_module("repro.core.versaq")
tqz = importlib.import_module("repro_torch.core.quantize")
from repro_torch.core import transforms as ttr
from repro_torch.core import versaq as tvq

RNG = np.random.default_rng(11)


def _arr(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n", [2, 32, 128])
def test_matrices_match(n):
    np.testing.assert_array_equal(_np(ttr.hadamard_matrix(n)), np.asarray(jtr.hadamard_matrix(n)))
    np.testing.assert_array_equal(_np(ttr.dct_matrix(n)), np.asarray(jtr.dct_matrix(n)))
    np.testing.assert_array_equal(
        _np(ttr.blocked_hadamard_matrix(3 * n)), np.asarray(jtr.blocked_hadamard_matrix(3 * n))
    )


@pytest.mark.parametrize("dim", [96, 128, 1024, 4096, 5120, 6144])
def test_block_size_for(dim):
    assert ttr.block_size_for(dim) == jtr.block_size_for(dim)
    assert ttr.block_size_for(dim, cap=64) == jtr.block_size_for(dim, cap=64)


@pytest.mark.parametrize("shape,block", [((3, 5, 128), None), ((4, 96), None), ((7, 256), 64)])
def test_fast_wht_bit_exact(shape, block):
    x = _arr(*shape)
    got = ttr.fast_wht(torch.as_tensor(x), block=block)
    want = jtr.fast_wht(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_apply_blocked():
    x = _arr(6, 256)
    d = jtr.dct_matrix(64)
    got = ttr.apply_blocked(torch.as_tensor(x), ttr.dct_matrix(64), 64)
    want = jtr.apply_blocked(jnp.asarray(x), d, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axis", [-1, None, (0,)])
def test_quantize_exact(bits, axis):
    x = _arr(9, 64, scale=3.0)
    x[2] = 0.0  # all-zero row: exercises the 1e-8 amax floor
    got = tqz.quantize(torch.as_tensor(x), bits, axis=axis)
    want = jqz.quantize(jnp.asarray(x), bits, axis=axis)
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))
    np.testing.assert_allclose(_np(got.scale), np.asarray(want.scale), rtol=1e-6, atol=0)


def test_round_half_to_even():
    # x / scale lands exactly on .5 boundaries: 127 * (k + 0.5) / 127.5
    x = np.array([[127.5, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32)
    got = _np(tqz.quantize_per_token(torch.as_tensor(x), 8).values)
    want = np.asarray(jqz.quantize_per_token(jnp.asarray(x), 8).values)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_int4(axis):
    v = RNG.integers(-7, 8, size=(8, 6)).astype(np.int8)
    got = tqz.pack_int4(torch.as_tensor(v), axis=axis)
    want = jqz.pack_int4(jnp.asarray(v), axis=axis)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(tqz.unpack_int4(got, axis=axis)), v)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_weight(bits):
    w = _arr(64, 48)
    got = tqz.quantize_weight(torch.as_tensor(w), bits)
    want = jqz.quantize_weight(jnp.asarray(w), bits)
    assert (got.packed, got.pack_axis, got.shape) == (want.packed, want.pack_axis, want.shape)
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))
    np.testing.assert_allclose(_np(got.scale), np.asarray(want.scale), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(got.dequantize()), np.asarray(want.dequantize()), rtol=1e-6)


def test_weight_folds_match():
    w = _arr(128, 96)
    tw, jw = torch.as_tensor(w), jnp.asarray(w)
    pairs = [
        (tvq.rotate_rows(tw), jvq.rotate_rows(jw)),
        (tvq.rotate_cols(tw), jvq.rotate_cols(jw)),
        (tvq.dct_cols(tw[:, :64]), jvq.dct_cols(jw[:, :64])),
        (tvq.fold_head_hadamard_in(tw, 4, 32), jvq.fold_head_hadamard_in(jw, 4, 32)),
        (tvq.fold_head_hadamard_out(tw, 3, 32), jvq.fold_head_hadamard_out(jw, 3, 32)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_folded_and_plain_norms(kind):
    x = _arr(5, 128, scale=2.0)
    tf = tvq.make_folded_norm(kind, 128)
    jf = jvq.make_folded_norm(kind, 128)
    if kind == "ln":
        np.testing.assert_array_equal(_np(tf.u), np.asarray(jf.u))
    np.testing.assert_allclose(
        _np(tvq.apply_norm(tf, torch.as_tensor(x))), np.asarray(jvq.apply_norm(jf, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5,
    )
    g, b = _arr(128), _arr(128)
    tn = tvq.Norm(g=torch.as_tensor(g), b=torch.as_tensor(b), kind=kind)
    jn = jvq.Norm(g=jnp.asarray(g), b=jnp.asarray(b), kind=kind)
    np.testing.assert_allclose(
        _np(tvq.apply_norm(tn, torch.as_tensor(x))), np.asarray(jvq.apply_norm(jn, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("policy", ["W4A8", "W8A8", "W4A4"])
def test_prepare_and_apply_linear(policy):
    """prepare_linear fuses γ/β, rotations and the DCT identically: integer
    weights equal except ±1 rounding flips (float32 summation order differs
    between the two matmul backends; at most 0.5% of entries, none seen at
    this seed), scales and biases to 1e-5, and the float-emulation apply to
    1e-5 relative."""
    w, g, b, bias = _arr(128, 128), _arr(128), _arr(128), _arr(128)
    kw = dict(rotate_in_offline=True, rotate_out_offline=True)
    tp = tvq.prepare_linear(
        torch.as_tensor(w), getattr(tvq, policy), gamma=torch.as_tensor(g),
        beta=torch.as_tensor(b), bias=torch.as_tensor(bias), **kw,
    )
    jp = jvq.prepare_linear(
        jnp.asarray(w), getattr(jvq, policy), gamma=jnp.asarray(g), beta=jnp.asarray(b),
        bias=jnp.asarray(bias), **kw,
    )
    assert (tp.a_bits, tp.idct, tp.rotate_input) == (jp.a_bits, jp.idct, jp.rotate_input)
    tv, jv = _np(tp.qw.unpacked_values()).astype(int), np.asarray(jp.qw.unpacked_values()).astype(int)
    diff = np.abs(tv - jv)
    assert diff.max() <= 1 and diff.sum() <= 0.005 * diff.size, (diff.max(), diff.sum())
    np.testing.assert_allclose(_np(tp.qw.scale), np.asarray(jp.qw.scale), rtol=1e-5)
    np.testing.assert_allclose(_np(tp.bias), np.asarray(jp.bias), rtol=1e-5, atol=1e-5)
    x = _arr(7, 128)
    got = _np(tvq.apply_linear(tp, torch.as_tensor(x)))
    want = np.asarray(jvq.apply_linear(jp, jnp.asarray(x)))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-5, rel


def test_precision_plan_matches_reference():
    """Site globbing (last match wins), level parsing and the JSON format
    agree with the reference's PrecisionPlan."""
    from repro.core.precision.plan import PrecisionPlan as JPlan
    from repro_torch.core.precision.plan import PrecisionPlan

    kw = dict(default="w4a8", overrides=(("*.ffn.*", "w8a8"), ("global.ffn.w_down", "bf16")),
              use_kernel=True, name="mix")
    tp, jp = PrecisionPlan(**kw), JPlan(**kw)
    sites = [f"{b}.{g}" for b in ("frame", "global")
             for g in ("attn.wq", "attn.wo", "ffn.w_up", "ffn.w_down")]
    for s in sites:
        assert tp.resolve(s) == jp.resolve(s)
        tpol, jpol = tp.policy_for(s), jp.policy_for(s)
        assert (tpol is None) == (jpol is None)
        if tpol is not None:
            assert (tpol.w_bits, tpol.a_bits, tpol.method) == (jpol.w_bits, jpol.a_bits, jpol.method)
    assert tp.to_json() == jp.to_json()
    assert PrecisionPlan.from_json(jp.to_json()) == tp
    assert [lp.level for lp in tp.describe(sites)] == [lp.level for lp in jp.describe(sites)]
    with pytest.raises(ValueError):
        PrecisionPlan(default="w4x8")
