"""The RWKV-6 path of the PyTorch port vs the JAX package at
``rwkv6-1.6b-smoke``: the configs, the time-mix and the channel-mix alone,
``lm.forward`` in ``full``, ``prefill`` and ``decode`` mode with the
recurrent state carried, ``quantize_lm`` under W4A8 (leaf by leaf, each
layer's branches and the whole model), decode against the full forward
(the reference's ``tests/models/test_decode.py`` on the port) and the
state rows of the cache surgery.

Weights come from the reference's ``lm.init_params`` (seed 0), carried
across with ``convert.params_from_numpy``; inputs from numpy.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.core.model_quant import quantize_lm as j_quantize_lm
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config
from repro_torch.convert import (
    kv_cache_from_numpy, kv_cache_to_numpy, params_from_numpy, params_to_numpy,
)
from repro_torch.core import versaq as tvq
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.kernels import probe
from repro_torch.models import lm
from repro_torch.models import rwkv as trwkv
from repro_torch.tree import tree_index

from test_torch_lm import MAX_INT_FLIPS, REL_L2, REL_L2_FLIP, _compare_trees, flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCH = "rwkv6-1.6b-smoke"


@functools.lru_cache(maxsize=1)
def _setup():
    jcfg = j_get_config(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH), jp, params_from_numpy(flatten_jax(jp))


@functools.lru_cache(maxsize=None)
def _trees(policy):
    jcfg, cfg, jp, tp = _setup()
    if policy == "fp":
        return jp, tp
    if policy == "w4a8":
        return j_quantize_lm(jcfg, jp, jvq.W4A8), quantize_lm(cfg, tp, tvq.W4A8)
    # the served tier: the same tree with every site routed to the kernel
    return None, quantize_lm(cfg, tp, PrecisionPlan(default="w4a8", use_kernel=True))


def _tokens(b=2, n=12, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (b, n)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _state_to_numpy(jcache):
    """The reference's decode cache (rwkv states only) as numpy dicts."""
    return {"prefix": [None for _ in jcache["prefix"]],
            "blocks": {n: {f: np.asarray(getattr(st, f)) for f in st._fields}
                       for n, st in jcache["blocks"].items()},
            "pos": np.asarray(jcache["pos"])}


def test_configs_match_reference():
    for name in ("rwkv6-1.6b", "rwkv6-1.6b-smoke"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))


def test_init_params_and_cache_layout_match_reference():
    """The port's own init builds the reference's tree (keys, shapes, dtypes,
    norm kinds) and its cache the reference's state shapes."""
    jcfg, cfg, jp, tp = _setup()
    own = params_to_numpy(lm.init_params(cfg, torch.Generator().manual_seed(0)))
    jl, jt = jax.tree_util.tree_flatten(flatten_jax(jp))
    ol, ot = jax.tree_util.tree_flatten(own)
    assert jt == ot
    for a, b in zip(jl, ol):
        assert np.asarray(a).shape == np.asarray(b).shape
        assert np.asarray(a).dtype == np.asarray(b).dtype
    jc = _state_to_numpy(jlm.init_cache(jcfg, 3, 16))
    tc = kv_cache_to_numpy(lm.init_cache(cfg, 3, 16))
    for n, st in jc["blocks"].items():
        for f, a in st.items():
            assert tc["blocks"][n][f].shape == a.shape and tc["blocks"][n][f].dtype == a.dtype
    assert tc["prefix"] == [] and isinstance(lm.init_cache(cfg, 1, 4)["blocks"]["l0"],
                                             trwkv.RWKVState)


def _layer0(policy):
    _, cfg, _, _ = _setup()
    jt, tt = _trees(policy)
    return (jax.tree_util.tree_map(lambda a: a[0], jt["blocks"]["l0"]),
            tree_index(tt["blocks"]["l0"], 0))


def _state(rng, b, cfg):
    nh = cfg.d_model // cfg.rwkv_head_dim
    return [rng.normal(size=s).astype(np.float32) * 0.5
            for s in ((b, 1, cfg.d_model), (b, 1, cfg.d_model),
                      (b, nh, cfg.rwkv_head_dim, cfg.rwkv_head_dim))]


@pytest.mark.parametrize("policy", ["fp", "w4a8"])
@pytest.mark.parametrize("carried", [False, True])
def test_time_and_channel_mix_match_reference(policy, carried):
    """One layer's time-mix (output, state, token shift) and channel-mix,
    with a zero or a carried-in state, on the same input: rel L2 1e-5."""
    jcfg, cfg, _, _ = _setup()
    jl, tl = _layer0(policy)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    ts, cs, wkv = _state(rng, 2, cfg)
    jst = jrwkv.RWKVState(jnp.asarray(ts), jnp.asarray(cs), jnp.asarray(wkv)) if carried else None
    tst = trwkv.RWKVState(*map(torch.as_tensor, (ts, cs, wkv))) if carried else None
    jo, js, jsh = jrwkv.rwkv_time_mix(jl["mixer"], jcfg, jnp.asarray(x), state=jst)
    to, tsl, tsh = trwkv.rwkv_time_mix(tl["mixer"], cfg, torch.as_tensor(x), state=tst)
    assert _rel(to, jo) < REL_L2 and _rel(tsl, js) < REL_L2
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    jo, jsh = jrwkv.rwkv_channel_mix(jl["ffn"], jcfg, jnp.asarray(x),
                                     prev=jnp.asarray(cs) if carried else None)
    to, tsh = trwkv.rwkv_channel_mix(tl["ffn"], cfg, torch.as_tensor(x),
                                     prev=torch.as_tensor(cs) if carried else None)
    assert _rel(to, jo) < REL_L2
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))


def _j_prefill_decode(jcfg, jp, toks, split):
    cache = jlm.init_cache(jcfg, toks.shape[0], 32)
    lg, cache = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :split]), cache=cache, mode="prefill")
    outs = [np.asarray(lg)]
    for t in range(split, toks.shape[1]):
        lg, cache = jlm.decode_step(jcfg, jp, jnp.asarray(toks[:, t]), cache)
        outs.append(np.asarray(lg))
    return outs, cache


def _t_prefill_decode(cfg, tp, toks, split):
    cache = lm.init_cache(cfg, toks.shape[0], 32)
    with torch.inference_mode():
        lg, cache = lm.forward(cfg, tp, torch.as_tensor(toks[:, :split]).long(), cache=cache,
                               mode="prefill")
        outs = [lg.numpy()]
        for t in range(split, toks.shape[1]):
            lg, cache = lm.decode_step(cfg, tp, torch.as_tensor(toks[:, t]).long(), cache)
            outs.append(lg.numpy())
    return outs, cache


@pytest.mark.parametrize("policy", ["fp", "w4a8"])
def test_forward_modes_match_reference(policy):
    """``full``, ``prefill`` and decode steps with the state carried: fp
    logits and states to 1e-5; W4A8 logits to the flip bound (one per-token
    int8 rounding within an ulp of a boundary may round apart and the
    recurrence carries it on), states likewise."""
    jcfg, cfg, _, _ = _setup()
    jt, tt = _trees(policy)
    toks = _tokens()
    bound = REL_L2 if policy == "fp" else REL_L2_FLIP
    jfull, _ = jlm.forward(jcfg, jt, jnp.asarray(toks))
    with torch.inference_mode():
        tfull, _ = lm.forward(cfg, tt, torch.as_tensor(toks).long())
    assert _rel(tfull, jfull) < bound
    jouts, jc = _j_prefill_decode(jcfg, jt, toks, 8)
    touts, tc = _t_prefill_decode(cfg, tt, toks, 8)
    for i, (g, w) in enumerate(zip(touts, jouts)):
        assert _rel(g, w) < bound, i
    assert tc["pos"] == 12 and int(jc["pos"]) == 12
    want = _state_to_numpy(jc)["blocks"]
    got = kv_cache_to_numpy(tc)["blocks"]
    for n in want:
        for f in ("tshift", "cshift", "wkv"):
            assert _rel(got[n][f], want[n][f]) < bound, (n, f)


def test_quantize_lm_leaf_parity():
    """No stream rotation (the embedding, norms and ``lm_head`` stay as
    they are), the seven projections a layer with the online WHT, the
    decay LoRA and ``ln_x`` full precision."""
    jt, tt = _trees("w4a8")
    flips = []
    _compare_trees(jt, tt, "q", flips)
    assert len(flips) == 7  # wr, wk, wv, wg, wo, w_up, w_down (one stacked entry each)
    assert sum(flips) <= MAX_INT_FLIPS, flips
    _, _, _, tp = _setup()
    np.testing.assert_array_equal(tt["embed"]["w"].numpy(), tp["embed"]["w"].numpy())
    l0 = tt["blocks"]["l0"]
    assert isinstance(l0["mixer_norm"], tvq.Norm) and isinstance(l0["mixer"]["wo"],
                                                                 tvq.QuantLinear)
    assert all(l0["mixer"][n].rotate_input for n in ("wr", "wk", "wv", "wg", "wo"))
    assert isinstance(l0["mixer"]["w_decay_a"], dict) and "lm_head" in tt


def test_w4a8_layers_launch_seven_quant_matmul_sites():
    """Each W4A8 layer routes its seven projections to the kernel wrapper
    (the plain version here, on the CPU: no launch is counted)."""
    _, cfg, _, _ = _setup()
    _, tt = _trees("served")
    sites = [tt["blocks"]["l0"]["mixer"][n] for n in ("wr", "wk", "wv", "wg", "wo")]
    sites += [tt["blocks"]["l0"]["ffn"][n] for n in ("w_up", "w_down")]
    assert all(s.use_kernel and s.qw.bits == 4 and s.a_bits == 8 for s in sites)
    with probe.tracking() as log, torch.inference_mode():
        lm.forward(cfg, tt, torch.as_tensor(_tokens()).long())
    assert log.count == 0


@pytest.mark.parametrize("policy,bound", [("fp", 1e-5), ("w4a8", 1e-5)])
def test_decode_equals_full(policy, bound):
    """The reference's own check (``tests/models/test_decode.py``) on the
    port: prefill + decode equals the full forward.  An rwkv stack has no
    KV cache, so its state carries the prefix exactly: even W4A8 holds
    1e-5 (per-token quantization sees the same rows either way)."""
    _, cfg, _, _ = _setup()
    _, tt = _trees(policy)
    toks = _tokens(n=12, seed=0)
    with torch.inference_mode():
        full, _ = lm.forward(cfg, tt, torch.as_tensor(toks).long())
    outs, _ = _t_prefill_decode(cfg, tt, toks, 8)
    dec = np.concatenate([outs[0]] + outs[1:], axis=1)
    assert _rel(dec, full.numpy()) < bound


def test_state_cache_surgery_matches_reference():
    """``cache_resize`` (grow, shrink) and ``cache_install_rows`` on the
    reference's prefilled states, carried across (a shift never rolls a
    state), the install writing the destination's own tensors."""
    jcfg, cfg, jp, _ = _setup()
    jsrc = jlm.init_cache(jcfg, 2, 16)
    _, jsrc = jlm.forward(jcfg, jp, jnp.asarray(_tokens(b=2, n=6, seed=2)), cache=jsrc,
                          mode="prefill")
    jdst = jlm.init_cache(jcfg, 3, 16)
    _, jdst = jlm.forward(jcfg, jp, jnp.asarray(_tokens(b=3, n=9, seed=3)), cache=jdst,
                          mode="prefill")
    tsrc = kv_cache_from_numpy(_state_to_numpy(jsrc))
    tdst = kv_cache_from_numpy(_state_to_numpy(jdst))

    def same(t, j):
        jn, tn = _state_to_numpy(j), kv_cache_to_numpy(t)
        for n, st in jn["blocks"].items():
            for f, a in st.items():
                np.testing.assert_array_equal(tn["blocks"][n][f], a, err_msg=f"{n}.{f}")

    for b in (5, 3, 1):
        same(lm.cache_resize(cfg, tdst, b), jlm.cache_resize(jcfg, jdst, b))
    want = jlm.cache_install_rows(jcfg, jdst, jsrc, [2, 0], [0, 1], shift=3)
    out = lm.cache_install_rows(cfg, tdst, tsrc, [2, 0], [0, 1], shift=3)
    same(out, want)
    same(tdst, want)  # written in place
    assert out["blocks"]["l0"].wkv.data_ptr() == tdst["blocks"]["l0"].wkv.data_ptr()
    same(lm.cache_set_clock(cfg, tsrc, 11), jsrc)


def test_pad_lens_and_mamba_refused():
    _, cfg, _, tp = _setup()
    with pytest.raises(ValueError, match="attention-only"):
        lm.forward(cfg, tp, torch.zeros((1, 4), dtype=torch.long),
                   pad_lens=torch.zeros(1, dtype=torch.long))
    # a Mamba layer beside rwkv builds, and pad_lens is refused there too
    hybrid = cfg.with_(pattern=("rwkv", "mamba"))
    hp = lm.init_params(hybrid, torch.Generator().manual_seed(0))
    assert "a_log" in hp["blocks"]["l1"]["mixer"]
    with pytest.raises(ValueError, match="attention-only"):
        lm.forward(hybrid, hp, torch.zeros((1, 4), dtype=torch.long),
                   pad_lens=torch.zeros(1, dtype=torch.long))
