"""quant_matmul of the PyTorch port (its plain version, which CPU tensors
take) vs the JAX Pallas kernel in interpret mode and its jnp oracle.

Tolerance rtol/atol 1e-5, the reference kernel test's own
(``tests/kernels/test_quant_matmul.py``): the integer part is exact on
both sides, only the two float scale multiplies round.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_per_token as j_qpt
from repro.core.quantize import quantize_weight as j_qw
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul as j_quant_matmul
from repro_torch.core.quantize import quantize_per_token, quantize_weight
from repro_torch.kernels import ops, probe
from repro_torch.kernels import quant_matmul as qm

RNG = np.random.default_rng(5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(m, k, n):
    return (RNG.normal(size=(m, k)).astype(np.float32),
            RNG.normal(size=(k, n)).astype(np.float32))


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("m,k,n,bn,bk", [(37, 128, 64, 64, 64), (13, 256, 192, 64, 128)])
def test_plain_matches_pallas_kernel(w_bits, m, k, n, bn, bk):
    """Odd M: the JAX kernel takes the whole M as one tile."""
    x, w = _mk(m, k, n)
    jw, jx = j_qw(jnp.asarray(w), w_bits), j_qpt(jnp.asarray(x), 8)
    tw, tx = quantize_weight(torch.as_tensor(w), w_bits), quantize_per_token(torch.as_tensor(x), 8)
    want = j_quant_matmul(
        jx.values, jx.scale, jw.values, jw.scale.reshape(1, -1),
        packed=jw.packed, bm=m, bn=bn, bk=bk, interpret=True,
    )
    oracle = jref.quant_matmul_ref(
        jx.values, jx.scale, jw.values, jw.scale.reshape(1, -1), packed=jw.packed
    )
    with probe.tracking() as log:
        got = qm.quant_matmul(tx.values, tx.scale, tw.values, tw.scale.reshape(1, -1),
                              packed=tw.packed)
    assert log.count == 0  # CPU tensors take the plain version: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_quant_linear_matmul_matches_reference_wrapper(w_bits, a_bits):
    """The public wrapper (per-token activation quantization + kernel) at
    an odd token count, against the reference wrapper, which lane-pads M."""
    x, w = _mk(3 * 7 * 5, 128, 96)
    x3 = x.reshape(3, 35, 128)
    jw = j_qw(jnp.asarray(w), w_bits)
    tw = quantize_weight(torch.as_tensor(w), w_bits)
    want = jops.quant_linear_matmul(jnp.asarray(x3), jw, a_bits=a_bits, interpret=True)
    got = ops.quant_linear_matmul(torch.as_tensor(x3), tw, a_bits=a_bits)
    assert tuple(got.shape) == tuple(want.shape) == (3, 35, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_is_exact_beyond_float32_mantissa():
    """W8A8 at K=4096 with saturated inputs: |acc| = 127·127·4096 ≈ 66M >
    2²⁴, which a float32 accumulator would round; the plain version sums in
    float64 and stays exact."""
    k = 4096
    xv = torch.full((2, k), 127, dtype=torch.int8)
    wv = torch.full((k, 4), 127, dtype=torch.int8)
    wv[0, 0] = 126  # exact sum is 127·127·4096 − 127, odd: not a float32 value
    one = torch.ones(2, 1)
    got = qm.quant_matmul_plain(xv, one, wv, torch.ones(1, 4), packed=False)
    exact = 127 * 127 * k - 127
    assert got[0, 0].item() == np.float32(exact)  # float(acc) rounds once, at the end
    assert got[0, 1].item() == np.float32(127 * 127 * k)
