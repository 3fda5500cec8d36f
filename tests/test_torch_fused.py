"""The unified datapath of the PyTorch port vs the JAX package, on the CPU.

The port's fused kernels run their plain versions here (CPU tensors); the
JAX side runs the Pallas kernels in interpret mode.  Inputs and weights
are made with numpy from a seed and handed to both sides.

Tolerances.  Float outputs: rel L2 1e-5 (both sides quantize the same
values; only the summation order of the norm statistics, the H_128 dot and
the IDCT differs).  Int8 outputs: equal except for ±1 flips where a value
lies within an ulp of a rounding boundary, at most ``MAX_FLIPS`` per
tensor; scales rtol 1e-6 (as ``tests/kernels/test_fused.py``).  The fused
FFN: 1e-3, because one ±1 flip of a requantized hidden entry moves the
output by about that much (``tests/kernels/test_fused.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as jtr
from repro.core import versaq as jvq
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro.kernels import wht as jwht
from repro_torch.core import versaq as tvq
from repro_torch.core.quantize import QTensor
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops, probe
from repro_torch.kernels import wht as twht

RNG = np.random.default_rng(13)
REL = 1e-5
REL_FFN = 1e-3
MAX_FLIPS = 2  # per int8 tensor (0 observed at these seeds)


def _np(shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_q(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).sum() <= MAX_FLIPS, (d.max(), (d > 0).sum())


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _tq(jq):
    return QTensor(values=_t(jq.values), scale=_t(jq.scale), bits=jq.bits, packed=jq.packed,
                   pack_axis=jq.pack_axis)


def _ql(j):
    """A JAX QuantLinear carried over leaf for leaf."""
    return tvq.QuantLinear(
        qw=_tq(j.qw), bias=_t(j.bias), a_bits=j.a_bits, rotate_input=j.rotate_input,
        idct=j.idct, dct_block=j.dct_block, use_kernel=j.use_kernel,
        prologue=None if j.prologue is None else tvq.Prologue(**dataclasses.asdict(j.prologue)),
        epilogue=None if j.epilogue is None else tvq.Epilogue(**dataclasses.asdict(j.epilogue)),
        norm_u=_t(j.norm_u),
    )


def _ffn(j):
    return tvq.FusedFFN(
        w_up=_ql(j.w_up), w_down=_ql(j.w_down),
        w_gate=None if j.w_gate is None else _ql(j.w_gate), norm_u=_t(j.norm_u), act=j.act,
        norm=j.norm, norm_eps=j.norm_eps,
    )


def _h(block):
    return None if block is None else jtr.hadamard_matrix(min(block, 128), dtype=jnp.float32)


def _u(kind, d):
    return np.asarray(jvq.make_folded_norm("ln", d).u) if kind == "ln" else None


# ---------------------------------------------------------------------------
# the kernels' plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

_BITS = [(8, 8), (4, 8), (4, 4)]
_EPIS = [  # (act, epilogue WHT, requant)
    ("none", False, None), ("gelu", True, "a"), ("silu", True, "a"), ("gelu", False, None),
]


def _matmul_case(w_bits, a_bits, norm, pro_wht, epi, prequant, m=13, k=128, n=192):
    act, ewht, rq = epi
    rq = a_bits if rq == "a" else rq
    x, w = _np((m, k)), _np((k, n), 1 / np.sqrt(k))
    jw = jvq.quantize_weight(jnp.asarray(w), w_bits)
    bias = _np((n,))
    u = _u(norm, k)
    idct = rq is None  # the requant cases exercise the no-IDCT path
    xs = None
    xin = jnp.asarray(x)
    if prequant:
        jx = jvq.quantize_per_token(xin, a_bits)
        xin, xs = jx.values, jx.scale
        norm, pro_wht = None, False
    pro_b = jtr.block_size_for(k) if pro_wht else None
    epi_b = jtr.block_size_for(n) if ewht else None
    want = jfused.fused_matmul(
        xin, jw.values, jw.scale.reshape(1, -1), xs=xs, bias=jnp.asarray(bias),
        norm_u=None if u is None else jnp.asarray(u), h_pro=_h(pro_b), h_epi=_h(epi_b),
        dct=jtr.dct_matrix(64, dtype=jnp.float32) if idct else None, packed=jw.packed,
        a_bits=a_bits, norm_kind=norm, pro_wht_block=pro_b, act=act, epi_wht_block=epi_b,
        requant_bits=rq, dct_block=64 if idct else None, bm=m, interpret=True,
    )
    with probe.tracking() as log:
        got = tfused.fused_matmul(
            _t(xin), _t(jw.values), _t(jw.scale).reshape(1, -1), xs=_t(xs), bias=_t(bias),
            norm_u=_t(u), packed=jw.packed, a_bits=a_bits, norm_kind=norm, pro_wht_block=pro_b,
            act=act, epi_wht_block=epi_b, requant_bits=rq, dct_block=64 if idct else None,
        )
    assert log.count == 0  # CPU tensors take the plain version: no launch
    return got, want, rq


@pytest.mark.parametrize("norm,pro_wht", [("ln", True), ("rms", True), (None, False)])
@pytest.mark.parametrize("w_bits,a_bits", _BITS)
def test_fused_matmul_prologues_match_pallas(w_bits, a_bits, norm, pro_wht):
    got, want, _ = _matmul_case(w_bits, a_bits, norm, pro_wht, _EPIS[0], False)
    assert got.shape == (13, 192)
    assert _rel(got.numpy(), want) < REL


@pytest.mark.parametrize("epi", _EPIS[1:])
@pytest.mark.parametrize("w_bits,a_bits", _BITS)
def test_fused_matmul_epilogues_match_pallas(w_bits, a_bits, epi):
    got, want, rq = _matmul_case(w_bits, a_bits, "rms", True, epi, False)
    if rq is None:
        assert _rel(got.numpy(), want) < REL
        return
    (qv, qs), (jv, js) = got, want
    assert qv.dtype == torch.int8 and qv.shape == (13, 192) and qs.shape == (13, 1)
    _assert_q(qv.numpy(), jv)
    np.testing.assert_allclose(qs.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("w_bits,a_bits", _BITS)
def test_fused_matmul_prequantized_matches_pallas(w_bits, a_bits):
    got, want, _ = _matmul_case(w_bits, a_bits, None, False, _EPIS[3], True)
    assert _rel(got.numpy(), want) < REL


def _ffn_case(kind, w_bits, a_bits, m=13, d=128, dff=256):
    """kind: gelu (plain, ln, biases) | swiglu (gated, rms) | unrotated
    (gated SiLU with the input WHT, no norm) | rtn (gated, no norm, no
    rotations)."""
    method = "rtn" if kind == "rtn" else "versaq"
    pol = jvq.QuantPolicy(w_bits, a_bits, method)
    gated = kind != "gelu"
    rotated = kind in ("gelu", "swiglu")
    common = dict(rotate_in_offline=rotated, rotate_input_online=not rotated and method != "rtn",
                  use_kernel=True)
    bias = dict(bias=jnp.asarray(_np((dff,)))) if kind == "gelu" else {}
    up = jvq.prepare_linear(jnp.asarray(_np((d, dff), 1 / np.sqrt(d))), pol, **common, **bias)
    gate = (jvq.prepare_linear(jnp.asarray(_np((d, dff), 1 / np.sqrt(d))), pol, **common)
            if gated else None)
    down = jvq.prepare_linear(
        jnp.asarray(_np((dff, d), 1 / np.sqrt(dff))), pol, rotate_input_online=True,
        rotate_out_offline=rotated, use_kernel=True,
        **(dict(bias=jnp.asarray(_np((d,)))) if kind == "gelu" else {}),
    )
    norm = {"gelu": "ln", "swiglu": "rms"}.get(kind)
    f = jvq.FusedFFN(w_up=up, w_down=down, w_gate=gate, act="silu" if gated else "gelu",
                     norm=norm, norm_u=None if norm != "ln" else jnp.asarray(_u("ln", d)))
    return f, _np((m, d))


@pytest.mark.parametrize("kind,w_bits,a_bits", [
    ("gelu", 4, 8), ("gelu", 8, 8), ("swiglu", 4, 8), ("swiglu", 4, 4), ("unrotated", 4, 8),
    ("rtn", 4, 8),
])
def test_fused_ffn_matches_pallas(kind, w_bits, a_bits):
    jf, x = _ffn_case(kind, w_bits, a_bits)
    want = jops.fused_ffn_apply(jnp.asarray(x), jf, interpret=True)
    tf = _ffn(jf)
    got = tfused.fused_ffn(
        torch.as_tensor(x), tf.w_up.qw.values, tf.w_up.qw.scale, tf.w_down.qw.values,
        tf.w_down.qw.scale, wg=None if tf.w_gate is None else tf.w_gate.qw.values,
        wgs=None if tf.w_gate is None else tf.w_gate.qw.scale, bu=tf.w_up.bias,
        bd=tf.w_down.bias, norm_u=tf.norm_u, packed_g=tf.w_gate is not None and w_bits == 4,
        packed_u=w_bits == 4, packed_d=w_bits == 4, a_bits_in=a_bits, a_bits_mid=a_bits,
        norm_kind=tf.norm, act=tf.act, pro_wht_block=128 if kind == "unrotated" else None,
        mid_wht_block=256 if tf.w_down.rotate_input else None, idct_h=tf.w_up.idct,
        idct_out=tf.w_down.idct, dct_block=64,
    )
    assert got.shape == (13, 128)
    assert _rel(got.numpy(), want) < REL_FFN


@pytest.mark.parametrize("kind", ["rms", "ln", None])
@pytest.mark.parametrize("a_bits,wht", [(8, True), (4, True), (8, False)])
def test_norm_quant_matches_pallas(kind, a_bits, wht):
    x = _np((21, 256))
    u = _u(kind, 256)
    jv, js = jfused.norm_quant(
        jnp.asarray(x), None if u is None else jnp.asarray(u), _h(256 if wht else None),
        norm_kind=kind, wht_block=256 if wht else None, a_bits=a_bits, bm=21, interpret=True)
    tv, ts = tfused.norm_quant(torch.as_tensor(x), _t(u), norm_kind=kind,
                               wht_block=256 if wht else None, a_bits=a_bits)
    _assert_q(tv.numpy(), jv)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    deq = tv.numpy().astype(np.float32) * ts.numpy()
    assert _rel(deq, np.asarray(jv, np.float32) * np.asarray(js)) < REL


@pytest.mark.parametrize("r,d,block", [(8, 64, None), (16, 512, None), (4, 4096, None),
                                       (8, 1024, 128)])
def test_wht_matches_pallas(r, d, block):
    x = _np((r, d))
    want = jwht.wht(jnp.asarray(x), block=block, interpret=True)
    got = twht.wht(torch.as_tensor(x), block=block)
    assert _rel(got.numpy(), want) < REL


# ---------------------------------------------------------------------------
# the ops wrappers and the versaq layer API
# ---------------------------------------------------------------------------


def _site(w_bits=4, a_bits=8, k=128, n=192, method="versaq", **kw):
    w = _np((k, n), 1 / np.sqrt(k))
    return jvq.prepare_linear(jnp.asarray(w), jvq.QuantPolicy(w_bits, a_bits, method),
                              bias=jnp.asarray(_np((n,))), **kw)


def test_fused_linear_wrapper_matches_reference():
    """ln prologue + online input WHT + IDCT/bias epilogue, odd token count
    over a [3, 5, K] input (the reference wrapper lane-pads M)."""
    jq = _site(rotate_input_online=True, use_kernel=True, prologue=jvq.Prologue(norm="ln"),
               epilogue=jvq.Epilogue(), norm_u=jvq.make_folded_norm("ln", 128).u)
    x = _np((3, 5, 128))
    want = jops.fused_linear(jnp.asarray(x), jq, interpret=True)
    got = ops.fused_linear(torch.as_tensor(x), _ql(jq))
    assert got.shape == (3, 5, 192)
    assert _rel(got.numpy(), want) < REL


def test_fused_linear_requant_and_prequantized_wrappers():
    """A requant epilogue returns a QTensor; a norm_quant prologue output
    feeds a pre-quantized launch (the shared-input Q/K/V pattern)."""
    jq = _site(8, 8, method="rtn", use_kernel=True,
               epilogue=jvq.Epilogue(act="gelu", wht=True, requant_bits=8))
    x = _np((2, 7, 128))
    jo = jops.fused_linear(jnp.asarray(x), jq, interpret=True)
    to = ops.fused_linear(torch.as_tensor(x), _ql(jq))
    assert isinstance(to, QTensor) and to.bits == 8 and to.values.shape == (2, 7, 192)
    _assert_q(to.values.numpy(), jo.values)
    np.testing.assert_allclose(to.scale.numpy(), np.asarray(jo.scale), rtol=1e-6)

    jp = jops.norm_quant_prologue(jnp.asarray(x), norm="rms", wht=True, interpret=True)
    tp = ops.norm_quant_prologue(torch.as_tensor(x), norm="rms", wht=True)
    assert tp.values.shape == (2, 7, 128) and tp.scale.shape == (2, 7, 1)
    _assert_q(tp.values.numpy(), jp.values)
    plain = dataclasses.replace(jq, epilogue=jvq.Epilogue())
    want = jops.fused_linear(jp, plain, interpret=True)
    got = ops.fused_linear(tp, _ql(plain))
    assert got.shape == (2, 7, 192) and _rel(got.numpy(), want) < REL


def test_fused_ffn_apply_and_online_wht_wrappers():
    jf, x = _ffn_case("gelu", 4, 8)
    x3 = x[:12].reshape(3, 4, 128)
    want = jops.fused_ffn_apply(jnp.asarray(x3), jf, interpret=True)
    got = ops.fused_ffn_apply(torch.as_tensor(x3), _ffn(jf))
    assert got.shape == (3, 4, 128) and _rel(got.numpy(), want) < REL_FFN
    y = _np((2, 3, 256))
    want = jops.online_wht_2d(jnp.asarray(y), interpret=True)
    assert _rel(ops.online_wht_2d(torch.as_tensor(y)).numpy(), want) < REL


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("norm,epi", [
    ("ln", jvq.Epilogue()), ("rms", jvq.Epilogue(act="gelu", wht=True)),
    (None, jvq.Epilogue(act="silu")),
])
def test_apply_linear_fused_sites_match_reference(use_kernel, norm, epi):
    """Both routes of a descriptor-carrying site: the kernel launch and
    its emulation twin (``use_kernel=False``), against the reference's."""
    pro = None if norm is None else jvq.Prologue(norm=norm)
    jq = _site(rotate_in_offline=True, use_kernel=use_kernel, prologue=pro, epilogue=epi,
               norm_u=jvq.make_folded_norm("ln", 128).u if norm == "ln" else None)
    x = _np((9, 128))
    want = jvq.apply_linear(jq, jnp.asarray(x))
    with probe.tracking():
        got = tvq.apply_linear(_ql(jq), torch.as_tensor(x))
    assert _rel(got.numpy(), want) < REL


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_apply_ffn_matches_reference(use_kernel, kind):
    jf, x = _ffn_case(kind, 4, 8)
    if not use_kernel:
        jf = dataclasses.replace(jf, **{
            k: dataclasses.replace(getattr(jf, k), use_kernel=False)
            for k in ("w_up", "w_down", "w_gate") if getattr(jf, k) is not None})
    want = jvq.apply_ffn(jf, jnp.asarray(x))
    got = tvq.apply_ffn(_ffn(jf), torch.as_tensor(x))
    assert _rel(got.numpy(), want) < REL_FFN


def test_carries_norm():
    jq = _site(use_kernel=True, prologue=jvq.Prologue(norm="ln"), epilogue=jvq.Epilogue(),
               norm_u=jvq.make_folded_norm("ln", 128).u)
    tq = _ql(jq)
    assert tvq.carries_norm(tq) and tvq.carries_norm({"wqkv": tq})
    bare = dataclasses.replace(tq, prologue=tvq.Prologue(norm=None))
    assert not tvq.carries_norm(bare) and not tvq.carries_norm({"wq": tq})
    jf, _ = _ffn_case("gelu", 4, 8)
    assert tvq.carries_norm(_ffn(jf))
    assert not tvq.carries_norm(dataclasses.replace(_ffn(jf), norm=None))
    for j, t in ((jq, tq), ({"wqkv": jq}, {"wqkv": tq}), (jf, _ffn(jf))):
        assert jvq.carries_norm(j) == tvq.carries_norm(t)


def test_requant_epilogue_rejected_on_apply_linear():
    tq = _ql(_site(method="rtn", use_kernel=True, epilogue=jvq.Epilogue(requant_bits=8)))
    with pytest.raises(ValueError, match="requant"):
        tvq.apply_linear(tq, torch.zeros(8, 128))
