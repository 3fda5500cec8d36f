"""MLA (DeepSeek-V2's multi-head latent attention) in the PyTorch port vs
the JAX package at ``deepseek-v2-lite-16b-smoke``: the configs and their
parameter counts, ``init_mla``'s tree, ``mla_attention`` in its three
branches (full; a prefill of more than one token, which materializes K/V
and writes the compressed cache; a one-token prefill and decode, which are
absorbed), with and without left pads, the compressed int8 cache it
writes, the float attention at a q/k head dim other than v's,
``quantize_lm``'s MLA branch leaf by leaf and the weights the absorbed
decode reads, ``lm.forward`` and ``decode_step`` in fp and W4A8, the
reference's own prefill + decode bound, the cache surgery on the compressed
layout, and the kernel launches of a prefill wave and a decode step.  The
planner's sites and the compiler's schedules are held against the
reference's for this config in ``tests/test_torch_lm_planner.py`` (its
``ARCHS``).

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
from repro.core import transforms as jtransforms
from repro.core import versaq as jvq
from repro.core.model_quant import quantize_lm as j_quantize_lm
from repro.core.precision.plan import PrecisionPlan as JPlan
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import (
    kv_cache_from_numpy, kv_cache_to_numpy, params_from_numpy, params_to_numpy,
)
from repro_torch.core import versaq as tvq
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.precision import PrecisionPlan, compile_schedule
from repro_torch.kernels import probe
from repro_torch.models import attention as tattn
from repro_torch.models import lm
from repro_torch.tree import tree_index

from test_torch_lm import (
    REL_L2, REL_L2_FLIP, _assert_kv_close, _compare_trees, flatten_jax, jax_cache_to_numpy,
)
from test_torch_schedule_serving import _recording
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCH = "deepseek-v2-lite-16b-smoke"


@functools.lru_cache(maxsize=1)
def _setup():
    jcfg = j_get_config(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH), jp, params_from_numpy(flatten_jax(jp))


def _policies(name):
    if name == "fp":
        return None, None
    if name == "w4a8":  # the float emulation on both sides
        return jvq.W4A8, tvq.W4A8
    # kernel routing: Pallas in interpret mode against the plain versions;
    # "fused" fuses the dense FFN, and the MLA sites stay per-site
    fuse = name == "fused"
    return (JPlan(default="w4a8", use_kernel=True, fuse=fuse),
            PrecisionPlan(default="w4a8", use_kernel=True, fuse=fuse))


@functools.lru_cache(maxsize=None)
def _trees(name):
    jcfg, cfg, jp, tp = _setup()
    jpol, tpol = _policies(name)
    if jpol is None:
        return jp, tp
    return j_quantize_lm(jcfg, jp, jpol), quantize_lm(cfg, tp, tpol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tokens(b=2, n=16, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (b, n)).astype(np.int32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items() if k not in ("kind", "eps")}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(np.shape(tree))


# ---------------------------------------------------------------------------
# config and tree
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    """Both registered configs field for field, and the full config's
    parameter counts: the reference's 15.7e9 total and 2.7e9 active
    (``tests/models/test_archs_smoke.py``)."""
    for name in ("deepseek-v2-lite-16b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
    total, active = get_config("deepseek-v2-lite-16b").param_counts()
    assert (total, active) == j_get_config("deepseek-v2-lite-16b").param_counts()
    assert abs(total - 15.7e9) / 15.7e9 < 0.05 and abs(active - 2.7e9) / 2.7e9 < 0.08


def test_init_tree_matches_reference_shapes():
    """``init_mla`` through the port's own ``init_params``: wq [d, H(dn+dr)],
    w_kv_down [d, rank + dr], the RMS ``kv_norm`` over rank, w_k_up [rank,
    H dn], w_v_up [rank, H dv], wo [H dv, d], stacked over scan groups; the
    dense layer 0 at ``dense_d_ff``."""
    jcfg, cfg, jp, _ = _setup()
    tp = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(params_to_numpy(tp)) == _shapes(flatten_jax(jp))
    mx = tp["blocks"]["l0"]["mixer"]
    h, rank = cfg.n_heads, cfg.kv_lora_rank
    assert set(mx) == {"wq", "w_kv_down", "kv_norm", "w_k_up", "w_v_up", "wo"}
    assert mx["wq"]["w"].shape == (2, cfg.d_model, h * (cfg.qk_nope_dim + cfg.qk_rope_dim))
    assert mx["w_kv_down"]["w"].shape == (2, cfg.d_model, rank + cfg.qk_rope_dim)
    assert mx["kv_norm"].kind == "rms" and mx["kv_norm"].g.shape == (2, rank)
    assert mx["kv_norm"].b is None
    assert mx["w_v_up"]["w"].shape == (2, rank, h * cfg.v_head_dim)
    assert tp["prefix"][0]["ffn"]["w_up"]["w"].shape == (cfg.d_model, cfg.dense_d_ff)


def test_compressed_cache_layout():
    """One ``rank + dr`` int8 row and one scale a token and layer; ``v`` and
    ``v_scale`` are [..., 1, 1] placeholders, as in the reference."""
    jcfg, cfg, _, _ = _setup()
    want = jattn.init_kv_cache(jcfg, 3, 10, 2)
    got = tattn.init_kv_cache(cfg, 3, 10, 2)
    for f in ("k", "v", "k_scale", "v_scale"):
        assert tuple(getattr(got, f).shape) == tuple(getattr(want, f).shape), f
    assert tuple(got.k.shape) == (2, 3, 10, 1, cfg.kv_lora_rank + cfg.qk_rope_dim)
    assert got.k.dtype == torch.int8 and got.k_scale.dtype == torch.float32
    assert tuple(got.v.shape) == (2, 3, 10, 1, 1) and got.length == 0
    c = lm.init_cache(cfg, 2, 8)
    assert tuple(c["prefix"][0].k.shape) == (2, 8, 1, 80)
    assert tuple(c["blocks"]["l0"].k.shape) == (2, 2, 8, 1, 80)


# ---------------------------------------------------------------------------
# mla_attention
# ---------------------------------------------------------------------------


def _layer0(name):
    """The first scan group's mixer of a tree, both sides."""
    jt, tt = _trees(name)
    return (jax.tree_util.tree_map(lambda a: a[0], jt["blocks"]["l0"]["mixer"]),
            tree_index(tt["blocks"]["l0"], 0)["mixer"])


def _layer_cache(jcfg, cfg, b, s):
    jc = jattn.init_kv_cache(jcfg, b, s, 1)
    jc = jc._replace(k=jc.k[0], v=jc.v[0], k_scale=jc.k_scale[0], v_scale=jc.v_scale[0])
    tc = tattn.init_kv_cache(cfg, b, s, 1)
    tc = tc._replace(k=tc.k[0], v=tc.v[0], k_scale=tc.k_scale[0], v_scale=tc.v_scale[0])
    return jc, tc


def _assert_cache_equal(tc, jc):
    """The written compressed cache: int8 rows exact, scales to 1e-6."""
    assert tc.length == int(jc.length)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("mode", ["full", "prefill", "prefill1", "decode"])
@pytest.mark.parametrize("policy", ["fp", "w4a8"])
def test_mla_attention_matches_reference(policy, mode, pad):
    """One MLA layer: full mode; a prefill of 8 tokens into a fresh cache
    (materialized branch, compressed cache written); a one-token prefill
    (absorbed, as the reference takes it); one decode step on the
    reference's prefilled cache, carried across (absorbed: the query in the
    compressed domain over the dequantized cache).  Left pads [0, 3] shift
    positions and mask keys in every branch.  Outputs to REL_L2, the
    written cache int8-exact."""
    jcfg, cfg, _, _ = _setup()
    jmx, tmx = _layer0(policy)
    rng = np.random.default_rng(11)
    lq = 1 if mode == "prefill1" else 8
    x = rng.normal(size=(2, lq, cfg.d_model)).astype(np.float32)
    pad_lens = np.array([0, 3], np.int32) if pad else None
    jpad = None if pad_lens is None else jnp.asarray(pad_lens)
    tpad = None if pad_lens is None else _t(pad_lens).long()
    pos = np.arange(lq)[None]
    if pad:
        pos = np.maximum(pos - pad_lens[:, None], 0)
    if mode == "full":
        jo, _ = jattn.mla_attention(jmx, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                                    mode="full", pad_lens=jpad)
        to, tc = tattn.mla_attention(tmx, cfg, _t(x), positions=_t(pos), mode="full",
                                     pad_lens=tpad)
        assert tc is None and _rel(to.numpy(), jo) < REL_L2
        return
    jc, tc = _layer_cache(jcfg, cfg, 2, 16)
    jo, jc = jattn.mla_attention(jmx, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                                 cache=jc, mode="prefill", pad_lens=jpad)
    if mode != "decode":
        to, tc = tattn.mla_attention(tmx, cfg, _t(x), positions=_t(pos), cache=tc,
                                     mode="prefill", pad_lens=tpad)
        assert tc.length == lq
        _assert_cache_equal(tc, jc)
        assert _rel(to.numpy(), jo) < REL_L2
        return
    tc = tattn.KVCache(*[_t(getattr(jc, f)) for f in ("k", "v", "k_scale", "v_scale")],
                       length=int(jc.length))
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos1 = np.array([[8]]) if not pad else (8 - pad_lens)[:, None]
    jo, jc2 = jattn.mla_attention(jmx, jcfg, jnp.asarray(x1), positions=jnp.asarray(pos1),
                                  cache=jc, mode="decode", pad_lens=jpad)
    to, tc2 = tattn.mla_attention(tmx, cfg, _t(x1), positions=_t(pos1), cache=tc,
                                  mode="decode", pad_lens=tpad)
    assert tc2.length == 9
    _assert_cache_equal(tc2, jc2)
    assert _rel(to.numpy(), jo) < REL_L2


def test_mla_cache_is_written_in_place_and_overflow_raises():
    jcfg, cfg, _, _ = _setup()
    _, tmx = _layer0("fp")
    _, cache = _layer_cache(jcfg, cfg, 2, 4)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 3, cfg.d_model)),
                        dtype=torch.float32)
    _, c2 = tattn.mla_attention(tmx, cfg, x, cache=cache, mode="prefill")
    assert c2.k.data_ptr() == cache.k.data_ptr() and c2.length == 3
    assert bool((cache.k[:, :3] != 0).any()) and bool((cache.k[:, 3:] == 0).all())
    _, c3 = tattn.mla_attention(tmx, cfg, x[:, :1], cache=c2, mode="decode")
    assert c3.length == 4 and bool((cache.k[:, 3] != 0).any())
    with pytest.raises(ValueError, match="overflow"):
        tattn.mla_attention(tmx, cfg, x[:, :1], cache=c3, mode="decode")


@pytest.mark.parametrize("impl", ["vanilla", "flash", "two_stage"])
def test_float_attention_takes_a_v_head_dim_other_than_qk(impl):
    """The materialized branch's attention: q/k head dim ``dn + dr`` = 192
    and v head dim 128 (deepseek-v2-lite's), with a key mask and causal,
    over two 1024-key chunks, against the reference's ``sdpa_dispatch``."""
    jcfg, cfg, _, _ = _setup()
    jcfg, cfg = jcfg.with_(attn_impl=impl), cfg.with_(attn_impl=impl)
    rng = np.random.default_rng(3)
    q, k = (rng.normal(size=(1, 1100, 2, 192)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(1, 1100, 2, 128)).astype(np.float32)
    mask = np.arange(1100)[None, :] >= 5
    want = jattn.sdpa_dispatch(jcfg, *map(jnp.asarray, (q, k, v)), causal=True,
                               kv_mask=jnp.asarray(mask))
    got = tattn.sdpa_dispatch(cfg, *map(_t, (q, k, v)), causal=True, kv_mask=_t(mask))
    assert tuple(got.shape) == (1, 1100, 2, 128)
    assert _rel(got.numpy(), want) < REL_L2


# ---------------------------------------------------------------------------
# quantize_lm's MLA branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["w4a8", "kernel", "fused"])
def test_quantize_lm_mla_leaves_match_reference(policy):
    """The whole quantized tree leaf by leaf: ``wq`` with the pre-norm
    fold, ``w_kv_down`` with only its LoRA columns rotated (and no site
    name, as in the reference), ``kv_norm`` a folded RMS norm whose γ went
    into ``w_k_up``/``w_v_up``, the V/O head rotations; under ``fuse`` the
    MLA sites stay per-site.  Integer weights exact (no ±1 flip)."""
    jt, tt = _trees(policy)
    flips = []
    _compare_trees(jt, tt, "q", flips)
    assert sum(flips) == 0, flips
    for tree in (tt["prefix"][0], tree_index(tt["blocks"]["l0"], 1)):
        mx = tree["mixer"]
        assert set(mx) == {"wq", "w_kv_down", "kv_norm", "w_k_up", "w_v_up", "wo"}
        assert isinstance(mx["kv_norm"], tvq.FoldedNorm) and mx["kv_norm"].kind == "rms"
        assert mx["w_kv_down"].site is None and mx["wq"].site is not None
        assert not any(getattr(mx[n], "rotate_input", False) for n in ("w_k_up", "w_v_up"))
    # 80 columns at smoke width: no DCT; at full width 576 = 9 blocks of 64
    assert not tt["blocks"]["l0"]["mixer"]["w_kv_down"].idct
    full = compile_schedule(get_config("deepseek-v2-lite-16b").with_(n_layers=2),
                            PrecisionPlan(default="w4a8", use_kernel=True))
    kv = full.site("blocks.l0.mixer.w_kv_down")
    assert (kv.d_in, kv.d_out, kv.idct, kv.kernel) == (2048, 576, True, "matmul")


@pytest.mark.parametrize("policy", ["fp", "w4a8", "kernel"])
def test_absorbed_weights_match_reference(policy):
    """What the absorbed decode multiplies by: ``w_k_up``/``w_v_up``
    dequantized (W4 nibbles unpacked) with the blocked IDCT applied,
    against the reference's expression, to 1e-6 (fp: the raw weights)."""
    jmx, tmx = _layer0(policy)
    for name in ("w_k_up", "w_v_up"):
        j = jmx[name]
        if isinstance(j, dict):
            want = np.asarray(j["w"])
        else:
            want = j.qw.dequantize(jnp.float32)
            assert j.idct
            d = jtransforms.dct_matrix(j.dct_block, dtype=jnp.float32)
            want = np.asarray(jtransforms.apply_blocked(want, d, j.dct_block))
        got = tattn._absorbed_weight(tmx[name]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["fp", "w4a8", "kernel", "fused"])
def test_forward_matches_reference(policy):
    """``lm.forward(mode="full")`` logits: fp to REL_L2, W4A8 within the
    flip bound."""
    jcfg, cfg, _, _ = _setup()
    jt, tt = _trees(policy)
    toks = _tokens()
    want, _ = jlm.forward(jcfg, jt, jnp.asarray(toks))
    got, c = lm.forward(cfg, tt, _t(toks).long())
    assert c is None and tuple(got.shape) == (2, 16, cfg.vocab_size)
    assert _rel(got.numpy(), want) < (REL_L2 if policy == "fp" else REL_L2_FLIP)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("policy", ["fp", "w4a8", "kernel"])
def test_prefill_and_decode_match_reference(policy, pad):
    """A prefill of 8 tokens and 4 decode steps: the prefill logits and the
    compressed caches it wrote; then each decode step on the reference's
    own cache, carried across, so every step starts from the same state."""
    jcfg, cfg, _, _ = _setup()
    jt, tt = _trees(policy)
    toks = _tokens(n=12)
    pl = np.array([0, 3], np.int32) if pad else None
    jpad = None if pl is None else jnp.asarray(pl)
    tpad = None if pl is None else _t(pl).long()
    bound = REL_L2 if policy == "fp" else REL_L2_FLIP
    jc, tc = jlm.init_cache(jcfg, 2, 16), lm.init_cache(cfg, 2, 16)
    jl, jc = jlm.forward(jcfg, jt, jnp.asarray(toks[:, :8]), cache=jc, mode="prefill",
                         pad_lens=jpad)
    tl, tc = lm.forward(cfg, tt, _t(toks[:, :8]).long(), cache=tc, mode="prefill",
                        pad_lens=tpad)
    assert _rel(tl.numpy(), jl) < bound and tc["pos"] == 8
    # after the first layer the inputs differ in their last bits, so a
    # cache entry within an ulp of its rounding boundary may round one step
    # apart (each layer alone writes it exactly: test_mla_attention_...)
    want, got = jax_cache_to_numpy(jc), kv_cache_to_numpy(tc)
    for w, g in [*zip(want["prefix"], got["prefix"]), (want["blocks"]["l0"],
                                                       got["blocks"]["l0"])]:
        _assert_kv_close(g["k"], w["k"], "k", policy != "fp")
    for t in range(8, 12):
        tc = kv_cache_from_numpy(jax_cache_to_numpy(jc))
        jl, jc = jlm.decode_step(jcfg, jt, jnp.asarray(toks[:, t]), jc, pad_lens=jpad)
        tl, tc = lm.decode_step(cfg, tt, _t(toks[:, t]).long(), tc, pad_lens=tpad)
        assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
        assert tc["pos"] == t + 1 == tc["blocks"]["l0"].length
        assert _rel(tl.numpy(), jl) < bound, t


def _decode_vs_full(cfg, params, toks, split=8):
    full, _ = lm.forward(cfg, params, toks)
    cache = lm.init_cache(cfg, toks.shape[0], 32)
    _, cache = lm.forward(cfg, params, toks[:, :split], cache=cache, mode="prefill")
    outs = []
    for t in range(split, toks.shape[1]):
        sl, cache = lm.decode_step(cfg, params, toks[:, t], cache)
        outs.append(sl[:, 0])
    dec = torch.stack(outs, dim=1)
    return float((dec - full[:, split:]).norm() / full[:, split:].norm())


@pytest.mark.parametrize("policy,bound", [("fp", 0.1), ("w4a8", 0.35)])
def test_decode_equals_full(policy, bound):
    """The reference's own bound (``tests/models/test_decode.py``) on the
    port's two MLA paths: the materialized prefill and the absorbed decode
    over the int8 compressed cache against the full forward (fp 0.1; W4 +
    int8 cache 0.35).  No capacity drop: cf = n_experts."""
    _, cfg, _, _ = _setup()
    _, tt = _trees(policy)
    cfg = cfg.with_(capacity_factor=float(cfg.n_experts))
    assert _decode_vs_full(cfg, tt, _t(_tokens(n=12, seed=0)).long()) < bound


def test_cache_surgery_matches_reference():
    """``cache_resize``, ``cache_install_rows`` (with and without a time
    shift) and ``cache_set_clock`` on the reference's prefilled compressed
    caches, carried across: every array equal, the [..., 1, 1] slots too."""
    jcfg, cfg, jp, _ = _setup()
    jsrc = jlm.init_cache(jcfg, 2, 16)
    _, jsrc = jlm.forward(jcfg, jp, jnp.asarray(_tokens(b=2, n=6, seed=2)), cache=jsrc,
                          mode="prefill")
    jdst = jlm.init_cache(jcfg, 3, 16)
    _, jdst = jlm.forward(jcfg, jp, jnp.asarray(_tokens(b=3, n=9, seed=3)), cache=jdst,
                          mode="prefill")
    jdst = jlm.cache_set_clock(jcfg, jdst, 9)
    tsrc = kv_cache_from_numpy(jax_cache_to_numpy(jsrc))
    tdst = kv_cache_from_numpy(jax_cache_to_numpy(jdst))

    def same(t, j):
        jn, tn = jax_cache_to_numpy(j), kv_cache_to_numpy(t)
        assert tn["pos"] == int(jn["pos"])
        for tc, jc in [*zip(tn["prefix"], jn["prefix"]), (tn["blocks"]["l0"],
                                                          jn["blocks"]["l0"])]:
            for f in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(tc[f], jc[f], err_msg=f)
            assert (jc["length"] == tc["length"]).all()

    for b in (5, 3, 1):
        same(lm.cache_resize(cfg, tdst, b), jlm.cache_resize(jcfg, jdst, b))
    for shift in (0, 3):
        same(lm.cache_install_rows(cfg, tdst, tsrc, [2, 0], [0, 1], shift=shift),
             jlm.cache_install_rows(jcfg, jdst, jsrc, [2, 0], [0, 1], shift=shift))
    same(lm.cache_set_clock(cfg, tsrc, 11), jlm.cache_set_clock(jcfg, jsrc, 11))
    rolled = tattn.roll_kv(tsrc["blocks"]["l0"], 2)
    want = jattn.roll_kv(jsrc["blocks"]["l0"], 2)
    for f in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(rolled, f).numpy(), np.asarray(getattr(want, f)))


def test_prefill_and_decode_launches(monkeypatch):
    """On the kernel route an MLA layer's prefill wave launches
    ``quant_matmul`` at its five sites (wq, w_kv_down, w_k_up, w_v_up, wo)
    and its absorbed decode step at three (the up-projections are read as
    dequantized weights): what the compiled schedule's
    ``launches_per_forward`` predicts with ``decode`` off and on.  No
    two-stage launch: MLA attends in float in every mode."""
    _, cfg, _, tp = _setup()
    cfg = cfg.with_(attn_impl="two_stage")
    sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True))
    params = quantize_lm(cfg, tp, sched)
    _recording(monkeypatch)
    toks = _t(_tokens(n=12)).long()
    n, moe = cfg.n_layers, cfg.n_layers - cfg.first_dense
    prefill = sched.launches_per_forward(two_stage_attention=False)
    decode = sched.launches_per_forward(two_stage_attention=False, decode=True)
    assert prefill == {"quant_matmul": 5 * n + 3 * cfg.first_dense + 3 * moe,
                       "quant_matmul_batched": 3 * moe}
    assert decode == {**prefill, "quant_matmul": prefill["quant_matmul"] - 2 * n}
    assert sched.launches_per_forward(two_stage_attention=True) == prefill
    with torch.inference_mode():
        cache = lm.init_cache(cfg, 2, 16)
        with probe.tracking() as log:
            _, cache = lm.forward(cfg, params, toks[:, :8], cache=cache, mode="prefill",
                                  pad_lens=torch.tensor([0, 3]))
        assert log.by_name() == prefill
        for t in range(8, 10):
            with probe.tracking() as log:
                _, cache = lm.decode_step(cfg, params, toks[:, t], cache,
                                          pad_lens=torch.tensor([0, 3]))
            assert log.by_name() == decode, t
        with probe.tracking() as log:
            lm.forward(cfg, params, toks)
        assert log.by_name() == prefill
