"""The port's kernel oracles (``repro_torch/kernels/ref.py``) against the
JAX package's (``repro/kernels/ref.py``), the re-exports of
``repro_torch.core`` against ``repro.core``'s, and the small ported helpers
(``dequantize``, ``fake_quant``, ``apply_wht``, ``blocked_dct_matrix``,
``mixed_len_prompts``)."""
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import transforms as jtr
from repro.data.pipeline import mixed_len_prompts as j_mixed_len_prompts
from repro.kernels import ref as jref
from repro_torch.core import transforms as ttr
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.kernels import ref as tref
from repro_torch.kernels import two_stage_attention as tsa
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# both packages' ``core`` re-export a ``quantize`` function that shadows the module
jquant = importlib.import_module("repro.core.quantize")
tquant = importlib.import_module("repro_torch.core.quantize")

RNG = np.random.default_rng(9)
# float oracles: the same op order on float32 inputs (matmul summation
# order differs, ~1e-7 relative)
TOL = dict(rtol=1e-5, atol=1e-5)


def _f(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("packed", [False, True])
def test_quant_matmul_ref_matches(packed):
    x, w = _f(37, 64), _f(64, 48)
    jx, jw = jquant.quantize_per_token(jnp.asarray(x), 8), jquant.quantize_weight(jnp.asarray(w), 4 if packed else 8)
    want = jref.quant_matmul_ref(jx.values, jx.scale, jw.values, jw.scale.reshape(1, -1),
                                 packed=packed)
    got = tref.quant_matmul_ref(_t(jx.values), _t(jx.scale), _t(jw.values),
                                _t(jw.scale).reshape(1, -1), packed=packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("lq,lk,causal", [(16, 16, False), (16, 16, True), (5, 16, True),
                                          (16, 24, False)])
def test_attention_ref_matches_bottom_right_causal(lq, lk, causal):
    """Lq != Lk causal keeps the oracle's bottom-right convention."""
    q, k, v = _f(2, lq, 32), _f(2, lk, 32), _f(2, lk, 32)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal and lq < lk:  # bottom-right: the last query row sees every key
        full = tref.attention_ref(_t(q), _t(k), _t(v), causal=False)
        np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("dh,causal", [(32, False), (64, True), (128, True)])
def test_two_stage_attention_ref_matches(dh, causal):
    """The integer oracle on the same int8 operands, and (Lq == Lk, where
    the conventions agree) the kernel's plain version against it at the
    reference kernel test's 3e-4."""
    q, k, v = _f(3, 40, dh), _f(3, 40, dh), _f(3, 40, dh)
    jq, jk = jquant.quantize_per_token(jnp.asarray(q), 8), jquant.quantize_per_token(jnp.asarray(k), 8)
    vs = jnp.max(jnp.abs(jnp.asarray(v)), axis=(1, 2), keepdims=True) / 127.0
    vv = jnp.clip(jnp.round(jnp.asarray(v) / vs), -127, 127).astype(jnp.int8)
    want = jref.two_stage_attention_ref(jq.values, jq.scale, jk.values, jk.scale, vv, vs,
                                        causal=causal)
    args = [_t(a) for a in (jq.values, jq.scale, jk.values, jk.scale, vv, vs)]
    got = tref.two_stage_attention_ref(*args, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tsa.two_stage_attention_plain(*args, causal=causal)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("d", [64, 96, 4096])
def test_wht_ref_and_apply_wht_match(d):
    x = _f(5, d)
    np.testing.assert_allclose(tref.wht_ref(_t(x)).numpy(), np.asarray(jref.wht_ref(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_array_equal(ttr.apply_wht(_t(x)).numpy(),
                                  np.asarray(jtr.apply_wht(jnp.asarray(x))))


@pytest.mark.parametrize("dim,block", [(128, 64), (96, 64), (48, 16)])
def test_blocked_dct_matrix_matches(dim, block):
    np.testing.assert_array_equal(ttr.blocked_dct_matrix(dim, block).numpy(),
                                  np.asarray(jtr.blocked_dct_matrix(dim, block)))


@pytest.mark.parametrize("bits,axis", [(8, -1), (4, 0), (8, None)])
def test_fake_quant_and_dequantize_match(bits, axis):
    x = _f(6, 32)
    want = jquant.fake_quant(jnp.asarray(x), bits, axis=axis)
    np.testing.assert_array_equal(tquant.fake_quant(_t(x), bits, axis=axis).numpy(),
                                  np.asarray(want))
    q = tquant.quantize(_t(x), bits, axis=axis)
    np.testing.assert_array_equal(tquant.dequantize(q).numpy(), q.dequantize().numpy())


def test_core_reexports_match_reference():
    # what repro/core/__init__.py imports (its submodules aside)
    names = {n for n in dir(jcore)
             if not n.startswith("_") and not isinstance(getattr(jcore, n), types.ModuleType)}
    assert "quantize" in names and names <= set(tcore.__all__), names - set(tcore.__all__)
    assert tcore.quantize is tquant.quantize and tcore.W4A8.name == jcore.W4A8.name
    for n in names:  # the same kind of object: a function or class of that name, a policy
        got, want = getattr(tcore, n), getattr(jcore, n)
        assert getattr(got, "__name__", type(got).__name__) == \
            getattr(want, "__name__", type(want).__name__), n


@pytest.mark.parametrize("requests,prompt_len,seed", [(4, 8, 0), (5, 512, 0), (3, 13, 7)])
def test_mixed_len_prompts_match_reference(requests, prompt_len, seed):
    got = mixed_len_prompts(151_936, requests, prompt_len, seed)
    want = j_mixed_len_prompts(151_936, requests, prompt_len, seed)
    assert [p.shape for p in got] == [p.shape for p in want]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
