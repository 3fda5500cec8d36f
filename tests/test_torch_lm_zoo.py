"""phi3-mini-3.8b and paligemma-3b in the PyTorch port against the JAX
package, on the CPU.

phi3 is MHA (32/32 heads of 96) with SwiGLU; paligemma is MQA (8/1 heads of
256) with GeGLU and a stub frontend (``embed_inputs``: the model takes
``[B, L, d]`` embeddings through ``in_proj``).  Checked here: the configs
field for field; the bridged parameter trees (``convert.py``, ``in_proj``
included) and the port's own init against the reference's layout; the
per-head WHT at dh 96 (three 32-blocks) and 256; fp and W4A8 forwards of
the smoke configs; W4A8 ``mode="full"`` forwards with two-stage attention
at the new head dims, on narrow variants built with ``with_`` on both sides
(the smoke configs have dh 32), against the reference's Pallas kernel in
interpret mode; phi3's ``Engine`` ids against the reference's in bucket
and continuous mode; paligemma's prefill and ``decode_step`` over the int8
cache with embedding inputs, and its ``Engine``'s refusals against the
reference's.

Weights come from the reference's ``lm.init_params`` (seed 0), inputs from
numpy.  Bounds: ``REL_L2`` for full-precision logits and for one layer fed
the same input, ``REL_L2_KV`` for full-precision logits through the int8
cache, ``REL_L2_FLIP`` for quantized whole-model logits
(``tests/test_torch_lm.py`` says why each).
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
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import kv_cache_from_numpy, params_from_numpy, params_to_numpy
from repro_torch.core import versaq as tvq
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.kernels import two_stage_attention as tsa
from repro_torch.models import attention as tattn
from repro_torch.models import lm
from repro_torch.serving.engine import Engine
from repro_torch.tree import tree_index

from test_torch_lm import (
    REL_L2, REL_L2_FLIP, REL_L2_KV, _assert_kv_close, flatten_jax, jax_cache_to_numpy,
)

PHI3, PALI = "phi3-mini-3.8b-smoke", "paligemma-3b-smoke"
SMOKES = (PHI3, PALI)
# narrow variants that reach the two-stage kernel's new instances
NARROW = {96: (PHI3, dict(d_model=192, n_heads=2, n_kv_heads=2, head_dim=96)),
          256: (PALI, dict(n_heads=2, n_kv_heads=1, head_dim=256))}
W4A8 = PrecisionPlan(default="w4a8", use_kernel=True)


@functools.lru_cache(maxsize=None)
def _setup(arch, **kw):
    jcfg, cfg = j_get_config(arch).with_(**kw), get_config(arch).with_(**kw)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(flatten_jax(jp))


@functools.lru_cache(maxsize=None)
def _trees(arch, policy, narrow=None):
    kw = NARROW[narrow][1] if narrow else {}
    jcfg, cfg, jp, tp = _setup(arch, **kw)
    if policy == "fp":
        return jp, tp
    return j_quantize_lm(jcfg, jp, jvq.W4A8), quantize_lm(cfg, tp, W4A8)


def _inputs(cfg, b=2, n=16, seed=5):
    """Token ids, or seeded [B, L, d] embeddings for a stub frontend: numpy,
    then (jax, torch)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        x = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
        return jnp.asarray(x), torch.as_tensor(x)
    x = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    return jnp.asarray(x), torch.as_tensor(x).long()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", PHI3, "paligemma-3b", PALI])
def test_configs_match_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))


def test_full_configs_reach_the_new_head_dims():
    phi3, pali = get_config("phi3-mini-3.8b"), get_config("paligemma-3b")
    assert (phi3.n_heads, phi3.n_kv_heads, phi3.head_dim, phi3.act) == (32, 32, 96, "swiglu")
    assert (pali.n_heads, pali.n_kv_heads, pali.head_dim, pali.act) == (8, 1, 256, "geglu")
    assert pali.embed_inputs and not phi3.embed_inputs
    assert {phi3.head_dim, pali.head_dim} <= set(tsa.HEAD_DIMS)


@pytest.mark.parametrize("arch", SMOKES)
def test_bridged_tree_has_the_references_shapes(arch):
    """``convert`` carries the reference's tree across leaf for leaf
    (``in_proj`` included), and the port's own init builds the same
    layout."""
    _, cfg, jp, tp = _setup(arch)
    flat = flatten_jax(jp)
    jl, jt = jax.tree_util.tree_flatten(flat)
    bl, bt = jax.tree_util.tree_flatten(params_to_numpy(tp))
    assert jt == bt
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(lm.init_params(cfg, torch.Generator().manual_seed(0)))
    ol, ot = jax.tree_util.tree_flatten(own)
    assert ot == jt and [np.shape(a) for a in ol] == [np.shape(a) for a in jl]
    assert ("in_proj" in tp) == cfg.embed_inputs
    mx = tp["blocks"]["l0"]["mixer"]
    assert tuple(mx["wk"]["w"].shape) == (cfg.n_layers, cfg.d_model, cfg.n_kv_heads * cfg.head_dim)


@pytest.mark.parametrize("arch", SMOKES)
def test_quantized_tree_matches_reference(arch):
    """``quantize_lm`` at W4A8: the ``in_proj`` rotation and every leaf of
    the tree equal the reference's (integer weights exactly, scales and
    float leaves to 1e-6)."""
    jt, tt = _trees(arch, "w4a8")
    if get_config(arch).embed_inputs:
        np.testing.assert_allclose(tt["in_proj"]["w"].numpy(), np.asarray(jt["in_proj"]["w"]),
                                   rtol=1e-6, atol=1e-6)
    jmx, tmx = jt["blocks"]["l0"]["mixer"], tt["blocks"]["l0"]["mixer"]
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(tmx[name].qw.values.numpy(),
                                      np.asarray(jmx[name].qw.values), err_msg=name)
        np.testing.assert_allclose(tmx[name].qw.scale.numpy(), np.asarray(jmx[name].qw.scale),
                                   rtol=1e-6, err_msg=name)
    jff, tff = jt["blocks"]["l0"]["ffn"], tt["blocks"]["l0"]["ffn"]
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tff[name].qw.values.numpy(),
                                      np.asarray(jff[name].qw.values), err_msg=name)


@pytest.mark.parametrize("dh", [96, 256])
def test_head_wht_matches_reference(dh):
    """The online per-head WHT of Q/K: blocked, three 32-blocks at dh 96
    (``transforms.block_size_for``), one 256-block at dh 256."""
    x = np.random.default_rng(dh).normal(size=(2, 5, 3, dh)).astype(np.float32)
    got = tvq.head_wht(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jvq.head_wht(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["fp", "w4a8"])
@pytest.mark.parametrize("arch", SMOKES)
def test_forward_matches_reference(arch, policy):
    jcfg, cfg, _, _ = _setup(arch)
    jt, tt = _trees(arch, policy)
    jx, tx = _inputs(cfg)
    jl, _ = jlm.forward(jcfg, jt, jx)
    tl, _ = lm.forward(cfg, tt, tx)
    assert tuple(tl.shape) == (2, 16, cfg.vocab_size)
    assert _rel(tl.numpy(), jl) < (REL_L2 if policy == "fp" else REL_L2_FLIP)


@pytest.mark.parametrize("dh", [96, 256])
def test_two_stage_forward_at_new_head_dims_matches_pallas(monkeypatch, dh):
    """W4A8 ``mode="full"`` with ``attn_impl="two_stage"`` on a narrow
    variant at this head dim: once a layer the two-stage wrapper (its plain
    version on CPU tensors) against the reference's Pallas kernel in
    interpret mode, through the whole model.  Layer 0's attention, fed the
    same input on both sides, holds ``REL_L2``."""
    arch, kw = NARROW[dh]
    jcfg, cfg, _, _ = _setup(arch, **kw)
    jcfg, cfg = jcfg.with_(attn_impl="two_stage"), cfg.with_(attn_impl="two_stage")
    jt, tt = _trees(arch, "w4a8", dh)
    seen = []
    real = tsa.two_stage_attention

    def recording(qv, *a, **k):
        seen.append((tuple(qv.shape), k.get("q_heads"), k.get("kv_heads")))
        return real(qv, *a, **k)

    monkeypatch.setattr(tsa, "two_stage_attention", recording)
    jx, tx = _inputs(cfg)
    jl, _ = jlm.forward(jcfg, jt, jx)
    tl, _ = lm.forward(cfg, tt, tx)
    assert len(seen) == cfg.n_layers and all(s[0] == (2 * cfg.n_heads, 16, dh) for s in seen)
    if cfg.n_kv_heads != cfg.n_heads:
        assert all(s[1:] == (cfg.n_heads, cfg.n_kv_heads) for s in seen)
    assert _rel(tl.numpy(), jl) < REL_L2_FLIP
    jmx = jax.tree_util.tree_map(lambda a: a[0], jt["blocks"]["l0"]["mixer"])
    tmx = tree_index(tt["blocks"]["l0"], 0)["mixer"]
    h = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jo, _ = jattn.gqa_attention(jmx, jcfg, jnp.asarray(h), causal=True)
    to, _ = tattn.gqa_attention(tmx, cfg, torch.as_tensor(h), causal=True)
    assert _rel(to.numpy(), jo) < REL_L2


@pytest.mark.parametrize("policy", ["fp", "w4a8"])
def test_embedding_prefill_and_decode_match_reference(policy):
    """paligemma: a prefill of 8 embedding rows into the int8 cache (MQA:
    one K/V head), then 4 ``decode_step`` calls with ``[B, 1, d]``
    embeddings, each from the reference's own cache carried across."""
    jcfg, cfg, _, _ = _setup(PALI)
    jt, tt = _trees(PALI, policy)
    quantized = policy != "fp"
    jx, tx = _inputs(cfg, n=12, seed=9)
    jcache, tcache = jlm.init_cache(jcfg, 2, 16), lm.init_cache(cfg, 2, 16)
    assert tuple(tcache["blocks"]["l0"].k.shape) == (cfg.n_layers, 2, 16, 1, cfg.head_dim)
    jl, jcache = jlm.forward(jcfg, jt, jx[:, :8], cache=jcache, mode="prefill")
    tl, tcache = lm.forward(cfg, tt, tx[:, :8], cache=tcache, mode="prefill")
    bound = REL_L2_FLIP if quantized else REL_L2_KV
    assert _rel(tl.numpy(), jl) < bound
    for c in ("k", "v"):
        _assert_kv_close(getattr(tcache["blocks"]["l0"], c).numpy(),
                         getattr(jcache["blocks"]["l0"], c), c, quantized)
    for t in range(8, 12):
        tcache = kv_cache_from_numpy(jax_cache_to_numpy(jcache))
        jl, jcache = jlm.decode_step(jcfg, jt, jx[:, t:t + 1], jcache)
        tl, tcache = lm.decode_step(cfg, tt, tx[:, t:t + 1], tcache)
        assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
        assert tcache["pos"] == t + 1
        assert _rel(tl.numpy(), jl) < bound, t


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TIERS = ("quality", "balanced")
N_STEPS = 10
BUCKET = dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0)
CONTINUOUS = dict(max_len=64, max_batch=4, batch_buckets=(1, 2, 4), max_wait_s=0.0,
                  decode_steps_per_poll=4)


def _engines(arch, mode, kw):
    jcfg, cfg, jp, tp = _setup(arch)
    return (JEngine(jcfg, jp, tiers={"quality": None, "balanced": jvq.W4A8}, mode=mode, **kw),
            Engine(cfg, tp, tiers={"quality": None, "balanced": W4A8}, mode=mode, device="cpu",
                   **kw))


def _serve(eng, continuous):
    """Six ``mixed_len_prompts`` requests (12 and 9 tokens) over both tiers;
    continuous: two first, two joining after one burst, two after the next."""
    prompts = mixed_len_prompts(get_config(PHI3).vocab_size, 6, 12)
    if not continuous:
        reqs = [eng.enqueue(p, N_STEPS, tier=TIERS[i % 2]) for i, p in enumerate(prompts)]
        eng.flush()
        return [np.asarray(r.result()) for r in reqs]
    reqs = [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (0, 1)]
    eng.poll()
    reqs += [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (2, 3)]
    eng.poll()
    reqs += [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (4, 5)]
    eng.flush()
    return [np.asarray(r.result()) for r in reqs]


@pytest.mark.parametrize("mode", ["bucket", "auto"])
def test_phi3_engine_ids_match_reference(mode):
    """Greedy ids of both tiers equal the reference engine's, request for
    request, in bucket mode and in ``auto`` (continuous for phi3, with
    admissions mid-decode)."""
    jeng, teng = _engines(PHI3, mode, BUCKET if mode == "bucket" else CONTINUOUS)
    continuous = mode == "auto"
    want, got = _serve(jeng, continuous), _serve(teng, continuous)
    assert teng.stats.mode == ("continuous" if continuous else "bucket")
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == np.int32 and g.shape == (N_STEPS,)
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} ({TIERS[i % 2]})")
    if continuous:
        js, ts = jeng.stats.scheduler, teng.stats.scheduler
        assert ts.admitted_mid_decode >= 1
        assert (ts.admitted, ts.admitted_mid_decode) == (js.admitted, js.admitted_mid_decode)


def test_embedding_engine_refuses_as_the_reference():
    """paligemma's ``Engine`` constructs (the reference's does), ``auto``
    resolves to bucket mode, ``mode="continuous"`` is refused, and
    ``enqueue``/``generate`` refuse embeddings, with the reference's
    errors."""
    jcfg, cfg, jp, tp = _setup(PALI)
    jeng = JEngine(jcfg, jp, max_len=32)
    teng = Engine(cfg, tp, max_len=32, device="cpu")
    assert not jeng.continuous and not teng.continuous
    assert teng.stats.mode.startswith("bucket (mode='auto': decode feeds generated ids back")
    for eng_cls, c, p in ((JEngine, jcfg, jp), (Engine, cfg, tp)):
        kw = {} if eng_cls is JEngine else dict(device="cpu")
        with pytest.raises(ValueError, match="mode='continuous' needs an attention-only pattern"):
            eng_cls(c, p, max_len=32, mode="continuous", **kw)
    emb = np.random.default_rng(0).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="embed_inputs stub frontends are not servable"):
            eng.enqueue(emb, 4)
        with pytest.raises(ValueError, match=r"prompts must be \[B, L\] ints"):
            eng.generate(emb, 4)

