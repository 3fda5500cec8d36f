"""The MoE path of the PyTorch port vs the JAX package at
``deepseek-moe-16b-smoke``: the config and the parameter tree (the dense
prefix layer at ``dense_d_ff``), ``_moe_block`` and ``moe_ffn`` (dropless,
capacity drops, a token mask keeping pads out of capacity, two dispatch
blocks), ``moe_aux_loss``, ``quantize_lm``'s MoE branch leaf by leaf and a
quantized MoE layer (the emulation on both sides, and the batched
``quant_matmul`` route against the reference's ``vmap`` over its Pallas
kernel in interpret mode), ``lm.forward`` in full, prefill and decode with
and without ``pad_lens``, the batched kernel's plain version against
``vmap(quant_matmul)``, and the launch count of the routed experts.

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
from repro.core.precision.plan import PrecisionPlan as JPlan
from repro.kernels import quant_matmul as jqm
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import (
    kv_cache_from_numpy, kv_cache_to_numpy, params_from_numpy, params_to_numpy,
)
from repro_torch.core import versaq as tvq
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.core.quantize import quantize_per_token, quantize_weight
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import ffn
from repro_torch.models import lm
from repro_torch.tree import tree_index

from test_torch_lm import REL_L2, REL_L2_FLIP, flatten_jax, jax_cache_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCH = "deepseek-moe-16b-smoke"
# Full-precision logits through the int8 KV cache.  As for qwen3-14b-smoke
# (REL_L2_KV) a K/V value within an ulp of its rounding boundary may round
# one step apart; here one V flip in the first MoE layer (left-padded
# prefill, seed 5 tokens) carries through causal attention into 36 ±1
# flips (0.3%) of the second layer's K/V and moves that row's first decode
# logits 7.3e-4.  The layers themselves hold REL_L2.
REL_L2_KV_MOE = 2e-3
# ±1 K/V flips allowed: the cascade above, and the quantized trees'
# share of test_torch_lm.KV_FLIP_SHARE
KV_FLIP_SHARE_MOE = {False: 1e-2, True: 2e-2}


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
    # kernel routing: Pallas in interpret mode against the plain versions
    return (JPlan(default="w4a8", use_kernel=True),
            PrecisionPlan(default="w4a8", use_kernel=True))


@functools.lru_cache(maxsize=None)
def _trees(name):
    jcfg, cfg, jp, tp = _setup()
    jpol, tpol = _policies(name)
    if jpol is None:
        return jp, tp
    return j_quantize_lm(jcfg, jp, jpol), quantize_lm(cfg, tp, tpol)


def flatten_quantized(tree):
    """A JAX tree with quantized leaves -> ``convert``'s numpy form: each
    dataclass as its fields under ``"__class__"`` (``Norm`` as
    ``flatten_jax`` writes it)."""
    if isinstance(tree, jvq.Norm):
        return flatten_jax(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {"__class__": type(tree).__name__,
                **{f.name: flatten_quantized(getattr(tree, f.name))
                   for f in dataclasses.fields(tree)}}
    if isinstance(tree, dict):
        return {k: flatten_quantized(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [flatten_quantized(v) for v in tree]
    if isinstance(tree, (jax.Array, np.ndarray)):
        return np.asarray(tree)
    return tree


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _x(shape=(2, 16, 128), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(b=2, n=16, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (b, n)).astype(np.int32)


def _moe_layer(name, group=0):
    """Group ``group``'s MoE FFN of the ``name`` tree on both sides."""
    jt, tt = _trees(name)
    return (jax.tree.map(lambda a: a[group], jt["blocks"]["l0"]["ffn"]),
            tree_index(tt["blocks"]["l0"]["ffn"], group))


def _route(p_router_j, p_router_t, jcfg, x):
    """Both sides' top-k expert sets of the router on x [T, d]."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    jl = jlayers.dense(p_router_j, jnp.asarray(x)).astype(jnp.float32)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), jcfg.top_k)
    tl = tlayers.dense(p_router_t, torch.as_tensor(x)).to(torch.float32)
    _, tidx = torch.topk(torch.softmax(tl, dim=-1), jcfg.top_k, dim=-1)
    return np.sort(np.asarray(jidx), -1), np.sort(tidx.numpy(), -1)


# ---------------------------------------------------------------------------
# config and tree
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    for name in ("deepseek-moe-16b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items() if k not in ("kind", "eps")}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(np.shape(tree))


def test_init_tree_matches_reference_shapes():
    """The port's own ``init_params`` builds the reference's tree: the
    first_dense prefix layer a dense FFN at ``dense_d_ff`` (not ``d_ff``),
    the scanned layers stacked routed experts, a router and the shared
    experts at ``n_shared_experts * moe_d_ff``."""
    jcfg, cfg, jp, _ = _setup()
    tp = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(params_to_numpy(tp)) == _shapes(flatten_jax(jp))
    assert tp["prefix"][0]["ffn"]["w_up"]["w"].shape == (cfg.d_model, cfg.dense_d_ff)
    ex = tp["blocks"]["l0"]["ffn"]["experts"]
    assert ex["w_down"].shape == (2, cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    shared = tp["blocks"]["l0"]["ffn"]["shared"]["w_up"]["w"]
    assert shared.shape == (2, cfg.d_model, cfg.n_shared_experts * cfg.moe_d_ff)
    assert [lm.ffn_kind(cfg, i) for i in range(cfg.n_layers)] == ["dense", "moe", "moe"]


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


# dropless: cf = e / k makes cap = tb; drops: cf 1e-9 quantizes to 0
# quarters, so every expert keeps one token; the mask case pads the head of
# one row (as a left-padded prompt) and the tail of the other
_CASES = {"default": {}, "dropless": dict(capacity_factor=4.0),
          "drops": dict(capacity_factor=1e-9), "blocks2": dict(moe_dispatch_blocks=2)}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_matches_reference(case, masked):
    jcfg, cfg, _, _ = _setup()
    jcfg, cfg = jcfg.with_(**_CASES[case]), cfg.with_(**_CASES[case])
    jl, tl = _moe_layer("fp")
    x = _x()
    mask = None
    if masked:
        mask = np.ones((2, 16), bool)
        mask[0, :5] = False
        mask[1, 13:] = False
    want = jffn.moe_ffn(jl, jcfg, jnp.asarray(x),
                        token_mask=None if mask is None else jnp.asarray(mask))
    got = ffn.moe_ffn(tl, cfg, torch.as_tensor(x),
                      token_mask=None if mask is None else torch.as_tensor(mask))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, want) < REL_L2


def test_moe_block_excludes_masked_tokens_from_capacity():
    """``_moe_block`` on one block: masked tokens get nothing back and take
    no capacity, so the real tokens' outputs equal the unpadded block's
    (whose static capacity the dynamic one reproduces) and the reference's."""
    jcfg, cfg, _, _ = _setup()
    jl, tl = _moe_layer("fp")
    x = _x((16, 128), seed=2)
    mask = np.ones(16, bool)
    mask[:6] = False
    want = jffn._moe_block(jl, jcfg, jnp.asarray(x), jnp.asarray(mask))
    got = ffn._moe_block(tl, cfg, torch.as_tensor(x), torch.as_tensor(mask))
    assert _rel(got, want) < REL_L2
    assert float(got[:6].abs().max()) == 0.0
    alone = ffn._moe_block(tl, cfg, torch.as_tensor(x[6:]))
    assert _rel(got[6:], alone) < REL_L2
    # at the smoke width (8 experts, top-2, cf 1.25) capacity binds: 16
    # tokens would keep 5 slots an expert, the 10 real ones keep 4
    assert ffn._cap(cfg, 16) == 5 and ffn._cap(cfg, 10) == 4


def test_moe_aux_loss_matches_reference():
    jcfg, cfg, _, _ = _setup()
    jl, tl = _moe_layer("fp")
    x = _x(seed=4)
    want = float(jffn.moe_aux_loss(jl, jcfg, jnp.asarray(x)))
    got = float(ffn.moe_aux_loss(tl, cfg, torch.as_tensor(x)))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# quantize_lm's MoE branch
# ---------------------------------------------------------------------------


def test_quantized_moe_leaves_match_reference():
    """Router folded fp, expert-stacked ``QuantLinear``s [G, E, ...] and the
    shared experts' sites: the same integer weights, scales and flags."""
    jt, tt = _trees("w4a8")
    for where in ("prefix", "blocks"):
        jf = jt["prefix"][0]["ffn"] if where == "prefix" else jt["blocks"]["l0"]["ffn"]
        tf = tt["prefix"][0]["ffn"] if where == "prefix" else tt["blocks"]["l0"]["ffn"]
        if where == "prefix":  # the dense layer 0 at dense_d_ff
            assert tuple(tf["w_up"].qw.values.shape) == tuple(jf["w_up"].qw.values.shape)
            continue
        np.testing.assert_allclose(tf["router"]["w"].numpy(), np.asarray(jf["router"]["w"]),
                                   rtol=1e-6, atol=1e-6)
        assert tf["router"]["b"] is None and jf["router"]["b"] is None
        for part in ("experts", "shared"):
            for name in ("w_gate", "w_up", "w_down"):
                j, t = jf[part][name], tf[part][name]
                assert tuple(t.qw.values.shape) == tuple(j.qw.values.shape), (part, name)
                assert (t.qw.bits, t.qw.packed, t.qw.pack_axis, t.a_bits, t.rotate_input,
                        t.idct, t.site) == (j.qw.bits, j.qw.packed, j.qw.pack_axis, j.a_bits,
                                            j.rotate_input, j.idct, j.site), (part, name)
                np.testing.assert_array_equal(t.qw.values.numpy(), np.asarray(j.qw.values))
                np.testing.assert_allclose(t.qw.scale.numpy(), np.asarray(j.qw.scale),
                                           rtol=1e-6)
    ex = tt["blocks"]["l0"]["ffn"]["experts"]["w_down"]
    assert tuple(ex.qw.values.shape) == (2, 8, 32, 128) and ex.rotate_input


def test_quantized_tree_crosses_the_bridge():
    """The reference's quantized MoE tree through ``convert`` gives the
    port's own ``quantize_lm`` integer leaves, and logits within the flip
    bound (the float leaves, the rotated embedding and the folded router
    and head, differ in their last bits, which flips int8 roundings); the
    port's tree makes the round trip exactly."""
    jcfg, cfg, _, _ = _setup()
    jt, tt = _trees("w4a8")
    bridged = params_from_numpy(flatten_quantized(jt))
    ex = bridged["blocks"]["l0"]["ffn"]["experts"]["w_up"]
    assert type(ex).__name__ == "QuantLinear" and ex.qw.values.dtype == torch.uint8
    assert torch.equal(ex.qw.values, tt["blocks"]["l0"]["ffn"]["experts"]["w_up"].qw.values)
    toks = torch.as_tensor(_tokens()).long()
    got, _ = lm.forward(cfg, bridged, toks)
    want, _ = lm.forward(cfg, tt, toks)
    assert _rel(got, want) < REL_L2_FLIP
    back = params_from_numpy(params_to_numpy(tt))
    again, _ = lm.forward(cfg, back, toks)
    assert torch.equal(again, want)


@pytest.mark.parametrize("name", ["w4a8", "kernel"])
def test_quantized_moe_layer_matches_reference(name):
    """One W4A8 MoE layer fed the same rotated-stream input: equal routing
    (the router is fp), outputs within the flip bound of whole-model
    quantized readings (a per-token int8 rounding within an ulp of its
    boundary may flip in another summation order)."""
    jcfg, cfg, _, _ = _setup()
    jl, tl = _moe_layer(name, group=1)
    x = _x(seed=6)
    jidx, tidx = _route(jl["router"], tl["router"], jcfg, x.reshape(-1, 128))
    np.testing.assert_array_equal(tidx, jidx)
    for mask in (None, np.arange(16)[None, :] >= np.array([[0], [4]])):
        want = jffn.moe_ffn(jl, jcfg, jnp.asarray(x),
                            token_mask=None if mask is None else jnp.asarray(mask))
        got = ffn.moe_ffn(tl, cfg, torch.as_tensor(x),
                          token_mask=None if mask is None else torch.as_tensor(mask))
        assert _rel(got, want) < REL_L2_FLIP


def test_routed_experts_are_one_launch_per_projection(monkeypatch):
    """On the kernel route each MoE layer's routed experts make one batched
    launch per projection (3, not 3 x n_experts), also with two dispatch
    blocks; the dense prefix layer and the shared experts take the 2-D
    launch."""
    _, cfg, _, _ = _setup()
    _, tt = _trees("kernel")
    calls = []
    for name in ("quant_matmul", "quant_matmul_batched"):
        fn = getattr(qm, name)

        def counting(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(a[0].shape)))
            return _fn(*a, **kw)

        monkeypatch.setattr(qm, name, counting)
    toks = torch.as_tensor(_tokens()).long()
    for blocks in (0, 2):
        calls.clear()
        lm.forward(cfg.with_(moe_dispatch_blocks=blocks), tt, toks)
        batched = [s for n, s in calls if n == "quant_matmul_batched"]
        moe_layers = cfg.n_layers - cfg.first_dense
        assert len(batched) == 3 * moe_layers
        nb = blocks or 1
        cap = ffn._cap(cfg, 32 // nb)
        assert all(s == (nb * cfg.n_experts, cap, s[2]) for s in batched), batched
        # 4 attention projections a layer, 3 dense FFN sites at layer 0 and
        # 3 shared-expert sites a MoE layer
        assert sum(n == "quant_matmul" for n, _ in calls) == 4 * cfg.n_layers + 3 + 3 * moe_layers


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp", "w4a8"])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_prefill_decode_match_reference(name, padded):
    """``lm.forward`` in full mode, then a prefill and 3 decode steps
    through the int8 KV cache, with and without left padding (``pad_lens``
    also masks the pads out of routing)."""
    jcfg, cfg, _, _ = _setup()
    jt, tt = _trees(name)
    toks = _tokens()
    pad = np.array([0, 5], np.int32) if padded else None
    jpad = None if pad is None else jnp.asarray(pad)
    tpad = None if pad is None else torch.as_tensor(pad).long()
    bound = REL_L2 if name == "fp" else REL_L2_FLIP
    want, _ = jlm.forward(jcfg, jt, jnp.asarray(toks), pad_lens=jpad)
    got, _ = lm.forward(cfg, tt, torch.as_tensor(toks).long(), pad_lens=tpad)
    real = slice(None) if pad is None else (slice(None), slice(5, None))
    assert _rel(got.numpy()[real], np.asarray(want)[real]) < bound

    jc = jlm.init_cache(jcfg, 2, 24)
    wl, jc = jlm.forward(jcfg, jt, jnp.asarray(toks), cache=jc, mode="prefill", pad_lens=jpad)
    tc = kv_cache_from_numpy(jax_cache_to_numpy(jlm.init_cache(jcfg, 2, 24)))
    gl, tc = lm.forward(cfg, tt, torch.as_tensor(toks).long(), cache=tc, mode="prefill",
                        pad_lens=tpad)
    bound = REL_L2_KV_MOE if name == "fp" else REL_L2_FLIP
    assert _rel(gl[:, -1], wl[:, -1]) < bound
    steps = np.random.default_rng(9).integers(0, 512, (3, 2)).astype(np.int32)
    for s in steps:
        wl, jc = jlm.decode_step(jcfg, jt, jnp.asarray(s), jc, pad_lens=jpad)
        gl, tc = lm.decode_step(cfg, tt, torch.as_tensor(s).long(), tc, pad_lens=tpad)
        assert gl.shape == (2, 1, cfg.vocab_size) and _rel(gl, wl) < bound
    want_kv, got_kv = jax_cache_to_numpy(jc), kv_cache_to_numpy(tc)
    for c in [*zip(want_kv["prefix"], got_kv["prefix"]), (want_kv["blocks"]["l0"],
                                                          got_kv["blocks"]["l0"])]:
        for f in ("k", "v"):
            d = np.abs(c[1][f].astype(np.int32) - c[0][f].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= KV_FLIP_SHARE_MOE[name != "fp"], f


def test_idle_decode_row_takes_no_capacity():
    """A decode row whose pad masks every key (a continuous runner's idle
    slot, pad ``max_len + 1``) is masked out of routing.  Decode's capacity
    is one slot an expert (cap = ceil(2 * 2 * 1.25 / 8) = 1), and the idle
    row comes first in the rank order, so a routed idle row sharing an
    expert with the live row would take its slot: whatever token the idle
    row holds, the live row's logits stay bit-equal."""
    _, cfg, _, _ = _setup()
    tt = _trees("fp")[1]
    toks = torch.as_tensor(_tokens(2)).long()
    cache = lm.init_cache(cfg, 2, 24)
    _, cache = lm.forward(cfg, tt, toks, cache=cache, mode="prefill")
    live = toks[1, 0]
    outs = []
    for idle in range(0, 512, 64):
        step = lm.cache_resize(cfg, cache, 2)  # a copy: the step writes its cache
        got, _ = lm.decode_step(cfg, tt, torch.stack([torch.tensor(idle), live]), step,
                                pad_lens=torch.tensor([25, 0]))
        outs.append(got[1])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    unmasked = []
    for idle in range(0, 512, 64):
        got, _ = lm.decode_step(cfg, tt, torch.stack([torch.tensor(idle), live]),
                                lm.cache_resize(cfg, cache, 2), pad_lens=torch.tensor([0, 0]))
        unmasked.append(got[1])
    # routed, the idle row does take the live row's slots for some tokens
    assert not all(torch.equal(o, unmasked[0]) for o in unmasked[1:])


# ---------------------------------------------------------------------------
# the batched kernel's plain version against vmap(quant_matmul)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_batched_plain_matches_reference_vmap(packed):
    """``quant_matmul_batched_plain`` against the reference's ``vmap`` over
    its Pallas ``quant_matmul`` in interpret mode (the routed experts'
    launch), exactly; with two dispatch blocks sharing the experts."""
    rng = np.random.default_rng(11 + packed)
    e, m, k, n = 4, 8, 128, 128
    x = rng.normal(size=(2 * e, m, k)).astype(np.float32)
    xq = quantize_per_token(torch.as_tensor(x), 8)
    ws_, wv_ = [], []
    for _ in range(e):
        wq = quantize_weight(torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32)),
                             4 if packed else 8)
        wv_.append(wq.values)
        ws_.append(wq.scale.reshape(1, -1))
    wv, ws = torch.stack(wv_), torch.stack(ws_)
    got = qm.quant_matmul_batched_plain(xq.values, xq.scale, wv, ws, packed=packed)

    def one(xv, xs, wv, ws):
        return jqm.quant_matmul(xv, xs, wv, ws, packed=packed, bm=8, bn=128, bk=128,
                                interpret=True)

    xv = jnp.asarray(xq.values.numpy()).reshape(2, e, m, k)
    xs = jnp.asarray(xq.scale.numpy()).reshape(2, e, m, 1)
    inner = jax.vmap(one)
    want = jax.vmap(lambda a, b: inner(a, b, jnp.asarray(wv.numpy()),
                                       jnp.asarray(ws.numpy())))(xv, xs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(2 * e, m, n))
    assert torch.equal(qm.quant_matmul_batched(xq.values, xq.scale, wv, ws, packed=packed), got)
