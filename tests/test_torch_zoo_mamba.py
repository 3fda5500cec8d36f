"""The Mamba mixer of the PyTorch port (``models/ssm.py``) against the JAX
package's, on the CPU: the parameter layout of ``init_mamba``, the selective
scan with and without a carried state, ``mamba_mixer`` in ``full``,
``prefill`` and decode mode (and prefill + decode against the full pass),
a W4A8 Mamba layer of jamba-v0.1-52b-smoke with its int8 activations
counted, and the decode-cache surgery on a ``MambaState``.

Weights come from the reference's ``init_mamba`` and ``lm.init_params``
(seed 0), carried across with ``convert.params_from_numpy``; inputs from
numpy.  Bounds: ``REL_L2`` (1e-5) for float outputs and states fed the same
inputs; ``REL_L2_FLIP`` for a quantized mixer in which an int8 activation
rounds one step apart (one flipped entry moves the output by ~1e-4-1e-3 at
this width); the conv window and the cache surgery exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import model_quant as j_model_quant
from repro.core import versaq as jvq
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import kv_cache_from_numpy, kv_cache_to_numpy, params_from_numpy
from repro_torch.core import model_quant as t_model_quant
from repro_torch.core import versaq as tvq
from repro_torch.models import lm
from repro_torch.models import ssm

from test_torch_lm import REL_L2, REL_L2_FLIP, flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCH = "jamba-v0.1-52b-smoke"
# int8 activations of a quantized mixer: ±1 on at most this share of entries
ACT_FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread: its smoke-size tensors gain
    nothing from more, and under ``pytest -n`` the workers' thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _mixer():
    """The reference's seed-0 Mamba mixer at jamba-smoke width, both sides."""
    jcfg = j_get_config(ARCH)
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
    return jcfg, get_config(ARCH), jp, params_from_numpy(flatten_jax(jp))


@functools.lru_cache(maxsize=1)
def _quantized_mixer():
    """A jamba-smoke Mamba layer (pattern position 1: Mamba mixer, dense
    FFN) from the reference's seed-0 ``_init_layer``, quantized at W4A8 (the
    float emulation on both sides) by each side's ``quantize_lm`` layer
    walk, as on a rotated stream (the reference's init and walk jitted);
    returns both mixers."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jl = jax.jit(lambda k: jlm._init_layer(k, jcfg, 1, jnp.float32))(jax.random.PRNGKey(0))
    tl = params_from_numpy(flatten_jax(jl))
    args = ("mamba", lm.ffn_kind(cfg, 1))
    jq = jax.jit(lambda p: j_model_quant._quantize_layer(
        jcfg, p, *args, j_model_quant._Resolver(jvq.W4A8), True, lead=0, pfx="blocks.l1"))(jl)
    tq = t_model_quant._quantize_layer(cfg, tl, *args, t_model_quant._Resolver(tvq.W4A8),
                                       True, lead=0, pfx="blocks.l1")
    return jq["mixer"], tq["mixer"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _x(cfg, b=2, n=12, seed=2):
    return np.random.default_rng(seed).normal(size=(b, n, cfg.d_model)).astype(np.float32)


def _state(cfg, b=2, seed=3):
    rng = np.random.default_rng(seed)
    di = cfg.mamba_expand * cfg.d_model
    return (rng.normal(size=(b, cfg.mamba_d_conv - 1, di)).astype(np.float32),
            rng.normal(size=(b, di, cfg.mamba_d_state)).astype(np.float32) * 0.5)


def test_init_mamba_layout_matches_reference():
    """``init_mamba`` builds the reference's leaves, shapes and dtypes
    (``dt_rank = d // 16``, ``w_dt`` with its bias), and its deterministic
    leaves equal the reference's: ``conv_b`` 0 and ``d_skip`` 1 exactly,
    ``a_log = log(1..ds)`` per channel to the last place (the port's float32
    ``log`` is correctly rounded; XLA's ``log(7)`` is one ulp above)."""
    _, cfg, jp, tp = _mixer()
    own = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    for name, jv in flatten_jax(jp).items():
        for tree in (tp, own):
            got = tree[name]
            if isinstance(jv, dict):
                assert set(got) == set(jv), name
                for k, v in jv.items():
                    assert (v is None) == (got[k] is None), (name, k)
                    if v is not None:
                        assert tuple(got[k].shape) == v.shape, (name, k)
            else:
                assert tuple(got.shape) == jv.shape and got.dtype == torch.float32, name
    assert own["w_xproj"]["w"].shape[1] == cfg.d_model // 16 + 2 * cfg.mamba_d_state
    for name in ("conv_b", "d_skip"):
        np.testing.assert_array_equal(own[name].numpy(), np.asarray(jp[name]), err_msg=name)
    np.testing.assert_array_max_ulp(own["a_log"].numpy(), np.asarray(jp["a_log"]), maxulp=1)
    np.testing.assert_array_equal(own["a_log"].numpy()[0],
                                  np.log(np.arange(1, cfg.mamba_d_state + 1)).astype(np.float32))


@pytest.mark.parametrize("carried", [False, True])
def test_selective_scan_matches_reference(carried):
    """The scan over time on seeded inputs (Δ positive, as softplus gives
    it), from zeros or from a carried state: y and the last state at
    ``REL_L2``."""
    _, cfg, jp, _ = _mixer()
    rng = np.random.default_rng(7)
    b, n = 2, 10
    di, ds = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    u = rng.normal(size=(b, n, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, n, di)))).astype(np.float32)
    bc = [rng.normal(size=(b, n, ds)).astype(np.float32) for _ in range(2)]
    d_skip = rng.normal(size=(di,)).astype(np.float32)
    h0 = _state(cfg, b)[1] if carried else None
    a = np.array(jp["a_log"])
    jy, jh = jssm._selective_scan(*map(jnp.asarray, (u, dt, a, *bc, d_skip)),
                                  None if h0 is None else jnp.asarray(h0))
    ty, th = ssm._selective_scan(*map(torch.as_tensor, (u, dt, a, *bc, d_skip)),
                                 None if h0 is None else torch.as_tensor(h0))
    assert tuple(ty.shape) == (b, n, di) and tuple(th.shape) == (b, di, ds)
    assert _rel(ty, jy) < REL_L2 and _rel(th, jh) < REL_L2


@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
def test_mamba_mixer_matches_reference(mode):
    """``full`` returns no state on either side; ``prefill`` returns the
    zero-padded conv's window and the scan's state; decode (one token)
    reads a carried window and state.  Outputs and states at ``REL_L2``;
    the window is the last ``d_conv - 1`` inputs of the conv exactly: the
    carried window shifted by one row and the step's own input."""
    jcfg, cfg, jp, tp = _mixer()
    x = _x(cfg, n=1 if mode == "decode" else 12)
    conv, h = _state(cfg)
    jst = jssm.MambaState(jnp.asarray(conv), jnp.asarray(h)) if mode == "decode" else None
    tst = ssm.MambaState(torch.as_tensor(conv), torch.as_tensor(h)) if mode == "decode" else None
    jo, jnew = jssm.mamba_mixer(jp, jcfg, jnp.asarray(x), state=jst, mode=mode)
    to, tnew = ssm.mamba_mixer(tp, cfg, torch.as_tensor(x), state=tst, mode=mode)
    assert tuple(to.shape) == x.shape and _rel(to, jo) < REL_L2
    if mode == "full":
        assert jnew is None and tnew is None
        return
    assert _rel(tnew.ssm, jnew.ssm) < REL_L2 and _rel(tnew.conv, jnew.conv) < REL_L2
    di = cfg.mamba_expand * cfg.d_model
    u = (torch.as_tensor(x) @ tp["w_in"]["w"])[..., :di]
    if mode == "decode":
        np.testing.assert_array_equal(tnew.conv[:, :-1].numpy(), conv[:, 1:])
        np.testing.assert_array_equal(tnew.conv[:, -1:].numpy(), u.numpy())
    else:
        np.testing.assert_array_equal(tnew.conv.numpy(), u[:, -(cfg.mamba_d_conv - 1):].numpy())


def test_prefill_then_decode_equals_full():
    """The reference's decode check on the mixer: a prefill of 8 tokens and
    4 one-token steps carrying the state give the full pass's outputs."""
    _, cfg, _, tp = _mixer()
    x = torch.as_tensor(_x(cfg, seed=4))
    full, _ = ssm.mamba_mixer(tp, cfg, x)
    outs, st = [], None
    for lo, hi in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12)):
        o, st = ssm.mamba_mixer(tp, cfg, x[:, lo:hi], state=st,
                                mode="prefill" if st is None else "decode")
        outs.append(o)
    assert _rel(torch.cat(outs, dim=1), full) < REL_L2


def _recorded_int8(monkeypatch, mod, fn, arg):
    """Run ``fn(arg)`` recording every per-token int8 activation the
    quantized linears of ``mod`` (a ``versaq`` module) produce."""
    seen, real = [], mod.quantize_per_token

    def record(x, bits):
        q = real(x, bits)
        seen.append(np.asarray(q.values).astype(np.int32))
        return q

    monkeypatch.setattr(mod, "quantize_per_token", record)
    out = fn(arg)
    monkeypatch.setattr(mod, "quantize_per_token", real)
    return out, seen


@pytest.mark.parametrize("seed", [6, 7])
def test_quantized_mixer_matches_reference(monkeypatch, seed):
    """A W4A8 Mamba mixer (``_quantized_mixer``), fed the same seeded input
    on both sides: ``w_in``'s and ``w_out``'s int8 activations equal the
    reference's or differ by ±1 on at most 0.1% of entries, and the mixer's
    output holds ``REL_L2`` where none differs, ``REL_L2_FLIP`` where one
    does."""
    jm, tm = _quantized_mixer()
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert isinstance(tm["w_in"], tvq.QuantLinear) and isinstance(tm["w_xproj"], dict)
    assert not tm["w_in"].rotate_input and tm["w_out"].rotate_input
    x = _x(cfg, n=16, seed=seed)
    jo, jq = _recorded_int8(monkeypatch, jvq, lambda a: jssm.mamba_mixer(jm, jcfg, a)[0],
                            jnp.asarray(x))
    to, tq = _recorded_int8(monkeypatch, tvq, lambda a: ssm.mamba_mixer(tm, cfg, a)[0],
                            torch.as_tensor(x))
    assert len(jq) == len(tq) == 2  # w_in, w_out
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(tq, jq)])
    n_flips = int((d > 0).sum())
    assert d.max() <= 1 and n_flips <= ACT_FLIP_SHARE * d.size, n_flips
    assert _rel(to, jo) < (REL_L2 if n_flips == 0 else REL_L2_FLIP), n_flips


def _cache_to_numpy(jcache):
    """The reference's decode cache (KV caches and Mamba states) as
    ``convert``'s numpy dicts."""
    def one(c):
        if isinstance(c, jssm.MambaState):
            return {f: np.asarray(getattr(c, f)) for f in c._fields}
        return {"k": np.asarray(c.k), "v": np.asarray(c.v), "k_scale": np.asarray(c.k_scale),
                "v_scale": np.asarray(c.v_scale), "length": np.asarray(c.length)}

    return {"prefix": [None if c is None else one(c) for c in jcache["prefix"]],
            "blocks": {n: one(c) for n, c in jcache["blocks"].items()},
            "pos": np.asarray(jcache["pos"])}


def _filled(jcfg, batch, seed):
    """A jamba-smoke cache on the reference's side with every Mamba leaf
    (and the attention layer's K/V) drawn from a seed, at clock 5."""
    rng = np.random.default_rng(seed)
    c = jlm.init_cache(jcfg, batch, 8)
    blocks = {}
    for n, e in c["blocks"].items():
        if isinstance(e, jssm.MambaState):
            blocks[n] = jssm.MambaState(*[jnp.asarray(rng.normal(size=a.shape), jnp.float32)
                                          for a in e])
        else:
            blocks[n] = e._replace(
                k=jnp.asarray(rng.integers(-127, 128, e.k.shape), jnp.int8),
                v=jnp.asarray(rng.integers(-127, 128, e.v.shape), jnp.int8),
                k_scale=jnp.asarray(rng.random(e.k_scale.shape), jnp.float32),
                v_scale=jnp.asarray(rng.random(e.v_scale.shape), jnp.float32),
                length=jnp.full_like(e.length, 5))
    return {"prefix": c["prefix"], "blocks": blocks, "pos": jnp.asarray(5, jnp.int32)}


def test_cache_surgery_on_mamba_states_matches_reference():
    """``cache_resize`` (grow, shrink) and ``cache_install_rows`` (with a
    shift, which rolls the attention layer's K/V and never a state) on
    jamba-smoke caches carried across from the reference: every leaf
    exact, the install writing the destination's own tensors."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jsrc, jdst = _filled(jcfg, 2, 0), _filled(jcfg, 3, 1)
    tsrc = kv_cache_from_numpy(_cache_to_numpy(jsrc))
    tdst = kv_cache_from_numpy(_cache_to_numpy(jdst))
    assert isinstance(tdst["blocks"]["l0"], ssm.MambaState)

    def same(t, j):
        jn, tn = _cache_to_numpy(j), kv_cache_to_numpy(t)
        for n, entry in jn["blocks"].items():
            for f, a in entry.items():
                if f != "length":
                    np.testing.assert_array_equal(tn["blocks"][n][f], a, err_msg=f"{n}.{f}")

    for b in (5, 3, 1):
        same(lm.cache_resize(cfg, tdst, b), jlm.cache_resize(jcfg, jdst, b))
    want = jlm.cache_install_rows(jcfg, jdst, jsrc, [2, 0], [0, 1], shift=2)
    out = lm.cache_install_rows(cfg, tdst, tsrc, [2, 0], [0, 1], shift=2)
    same(out, want)
    same(tdst, want)  # written in place
    assert out["blocks"]["l0"].ssm.data_ptr() == tdst["blocks"]["l0"].ssm.data_ptr()
    same(lm.cache_set_clock(cfg, tsrc, 7), jsrc)
