"""jamba-v0.1-52b in the PyTorch port against the JAX package, on the CPU:
the Mamba/attention hybrid (7 Mamba layers and 1 attention layer a period
of 8, no positions) with the MoE FFN every second layer (16 experts of
14,336 at top-2 at full width), at ``jamba-v0.1-52b-smoke``.

Checked here: the config's parameter counts; the bridged tree and the
port's own init against the reference's layout; ``quantize_lm`` at W4A8
leaf for leaf (``w_in`` absorbing the mixer norm, ``w_out`` with the
online WHT, Δ/B/C, the conv, ``a_log`` and ``d_skip`` in float); the fp
forward, and a prefill and decode steps through the int8 KV cache and the
``MambaState``; the W4A8 stack layer by layer; the planner's sites and the
compiled schedules against the reference's; the launches a schedule
predicts against those of a prefill wave, a decode step and a scoring
forward; the ``Engine`` in bucket mode (``mode="auto"``) against the
reference's, and from a compiled schedule; and a pure-Mamba variant served
through the continuous scheduler's ``StateDecodeRunner`` against the
reference's continuous engine.

Whole-model W4A8 logits at this size are chaotic: over seeded token draws
the port's own logits move 1.3e-3 to 7.5e-2 (relative L2) when each
embedding entry changes in its last bit, because a flipped int8 rounding
moves a token to another of 4 experts under capacity and the Mamba state
carries it to every later token.  The port's distance from the reference's
logits spans the same range, so the W4A8 stack is held layer by layer, each
layer fed the reference's own residual stream, at ``REL_L2_FLIP`` (the
mixer's int8 activations are counted in ``tests/test_torch_zoo_mamba.py``),
and the engine's W4A8 ids as ``test_torch_mla_engine._hold_ids`` holds a
rounding tie.

Weights come from the reference's ``lm.init_params`` (seed 0, jitted),
carried across with ``convert.params_from_numpy``; inputs from numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.core.model_quant import quantize_lm as j_quantize_lm
from repro.core.precision import compiler as jcomp
from repro.core.precision import plan as jplan_mod
from repro.core.precision import planner as jpl
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import kv_cache_to_numpy, params_from_numpy, params_to_numpy
from repro_torch.core import versaq as tvq
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.precision import PrecisionPlan, compile_schedule
from repro_torch.core.precision import planner as tpl
from repro_torch.kernels import probe
from repro_torch.models import lm
from repro_torch.models import ssm
from repro_torch.serving.engine import Engine, StateDecodeRunner
from repro_torch.tree import tree_index

from test_torch_compiler import _strip
from test_torch_lm import (
    MAX_INT_FLIPS, REL_L2, REL_L2_FLIP, REL_L2_KV, _compare_trees, flatten_jax,
)
from test_torch_zoo_mamba import _cache_to_numpy
from test_torch_schedule_serving import _recording
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCH = "jamba-v0.1-52b-smoke"
W4A8 = PrecisionPlan(default="w4a8", use_kernel=True)
FUSED = dict(default="w4a8", use_kernel=True, fuse=True, name="w4a8")
TIERS = ("quality", "balanced")
N_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread: its smoke-size tensors gain
    nothing from more, and under ``pytest -n`` the workers' thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(**kw):
    jcfg, cfg = j_get_config(ARCH).with_(**kw), get_config(ARCH).with_(**kw)
    jp = jax.jit(lambda k: jlm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(flatten_jax(jp))


@functools.lru_cache(maxsize=None)
def _trees(policy, **kw):
    """fp, or W4A8 through the float emulation on both sides (the
    reference's walk jitted)."""
    jcfg, cfg, jp, tp = _setup(**kw)
    if policy == "fp":
        return jp, tp
    jt = jax.jit(lambda p: j_quantize_lm(jcfg, p, jvq.W4A8))(jp)
    return jt, quantize_lm(cfg, tp, tvq.W4A8)


@functools.lru_cache(maxsize=None)
def _jforward(jcfg, mode):
    """The reference's ``lm.forward`` jitted per (config, mode): eagerly it
    retraces and recompiles its group scan on every call."""
    if mode == "full":
        return jax.jit(lambda p, x: jlm.forward(jcfg, p, x)[0])
    return jax.jit(lambda p, x, c, pad: jlm.forward(jcfg, p, x, cache=c, mode=mode,
                                                     pad_lens=pad))


def _tokens(b=2, n=16, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (b, n)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# config and trees
# ---------------------------------------------------------------------------


def test_param_counts_and_layout_match_reference():
    """51.4e9 parameters, 12.0e9 active (the reference's
    ``tests/models/test_archs_smoke.py``); each pattern position's mixer
    and FFN kind as the reference assigns them."""
    full, jfull = get_config("jamba-v0.1-52b"), j_get_config("jamba-v0.1-52b")
    total, active = full.param_counts()
    assert (total, active) == jfull.param_counts()
    assert abs(total / 1e9 - 51.4) < 0.1 and abs(active / 1e9 - 12.0) < 0.1
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    kinds = [(lm.mixer_kind(cfg, i), lm.ffn_kind(cfg, i)) for i in range(cfg.n_layers)]
    assert kinds == [(jlm.mixer_kind(jcfg, i), jlm.ffn_kind(jcfg, i)) for i in range(8)]
    assert [k for k, _ in kinds].count("attn") == 1 and [f for _, f in kinds].count("moe") == 4


def test_bridged_tree_has_the_references_shapes():
    """``convert`` carries the reference's tree across leaf for leaf (every
    Mamba leaf: ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, ``w_dt``'s
    bias), and the port's own init builds the same layout."""
    _, cfg, jp, tp = _setup()
    flat = flatten_jax(jp)
    jl, jt = jax.tree_util.tree_flatten(flat)
    bl, bt = jax.tree_util.tree_flatten(params_to_numpy(tp))
    assert jt == bt
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(lm.init_params(cfg, torch.Generator().manual_seed(0)))
    ol, ot = jax.tree_util.tree_flatten(own)
    assert ot == jt and [np.shape(a) for a in ol] == [np.shape(a) for a in jl]
    mx = tp["blocks"]["l0"]["mixer"]
    assert {"conv_w", "conv_b", "a_log", "d_skip"} <= set(mx) and mx["w_dt"]["b"] is not None
    assert tuple(tp["blocks"]["l0"]["ffn"]["experts"]["w_up"].shape) == (
        1, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)


def test_quantized_tree_matches_reference():
    """W4A8 leaf for leaf: integers equal but for ±1 flips, scales and
    float leaves to 1e-5; on a rotated stream ``w_in`` takes the mixer
    norm's γ/β and no online WHT, ``w_out`` the online WHT; the Mamba
    float leaves, the MoE router and ``w_xproj``/``w_dt`` stay float."""
    jt, tt = _trees("w4a8")
    flips = []
    _compare_trees(jt, tt, "q", flips)
    assert sum(flips) <= MAX_INT_FLIPS, flips
    mx = tt["blocks"]["l0"]["mixer"]
    assert not mx["w_in"].rotate_input and mx["w_out"].rotate_input
    assert isinstance(mx["w_xproj"], dict) and isinstance(mx["w_dt"], dict)
    assert isinstance(tt["blocks"]["l0"]["mixer_norm"], tvq.FoldedNorm)
    _, _, _, tp = _setup()
    for name in ("conv_w", "conv_b", "a_log", "d_skip"):
        assert torch.equal(mx[name], tp["blocks"]["l0"]["mixer"][name]), name


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


def test_fp_forward_prefill_decode_match_reference():
    """The full forward at ``REL_L2``; a prefill of 12 tokens and 4 decode
    steps through the int8 KV cache (the attention layer) and the
    ``MambaState`` (7 layers) at ``REL_L2_KV``, and the states after them
    at ``REL_L2_KV``."""
    jcfg, cfg, jp, tp = _setup()
    toks = _tokens()
    jl = _jforward(jcfg, "full")(jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = lm.forward(cfg, tp, torch.as_tensor(toks).long())
    assert tuple(tl.shape) == (2, 16, cfg.vocab_size) and _rel(tl, jl) < REL_L2
    jc, tc = jlm.init_cache(jcfg, 2, 24), lm.init_cache(cfg, 2, 24)
    assert isinstance(tc["blocks"]["l0"], ssm.MambaState)
    jl, jc = _jforward(jcfg, "prefill")(jp, jnp.asarray(toks[:, :12]), jc, None)
    with torch.inference_mode():
        tl, tc = lm.forward(cfg, tp, torch.as_tensor(toks[:, :12]).long(), cache=tc,
                            mode="prefill")
        assert _rel(tl, jl) < REL_L2_KV
        for t in range(12, 16):
            jl, jc = _jforward(jcfg, "decode")(jp, jnp.asarray(toks[:, t:t + 1]), jc, None)
            tl, tc = lm.decode_step(cfg, tp, torch.as_tensor(toks[:, t]).long(), tc)
            assert tuple(tl.shape) == (2, 1, cfg.vocab_size) and _rel(tl, jl) < REL_L2_KV, t
    assert tc["pos"] == 16
    want, got = _cache_to_numpy(jc)["blocks"], kv_cache_to_numpy(tc)["blocks"]
    for n, entry in want.items():
        for f in ("conv", "ssm") if "ssm" in entry else ():
            assert _rel(got[n][f], entry[f]) < REL_L2_KV, (n, f)


def test_w4a8_stack_matches_reference_layer_by_layer():
    """Each layer of the W4A8 stack (Mamba or attention mixer, MoE or dense
    FFN), fed the reference's own residual stream, at ``REL_L2_FLIP`` (an
    int8 activation that rounds one step apart moves its token's row by
    ~1e-4-1e-3 at this width, and a MoE layer may send it to another
    expert); the head on the reference's last stream at ``REL_L2``."""
    jcfg, cfg, _, _ = _setup()
    jt, tt = _trees("w4a8")
    toks = _tokens()
    pos = np.arange(16)[None]
    xj = jlm._embed_inputs(jcfg, jt, jnp.asarray(toks), jnp.asarray(pos))
    with torch.inference_mode():
        xt = lm._embed_inputs(cfg, tt, torch.as_tensor(toks).long(), torch.as_tensor(pos))
    assert _rel(xt, xj) == 0.0
    layers = {}  # the reference's layer, jitted per (mixer kind, FFN kind)
    for j, kind in enumerate(cfg.pattern):
        fk = lm.ffn_kind(cfg, j)
        if (kind, fk) not in layers:
            layers[kind, fk] = jax.jit(lambda lp, x, kind=kind, fk=fk: jlm._apply_layer(
                jcfg, lp, kind, fk, x, positions=jnp.asarray(pos))[0])
        want = layers[kind, fk](jax.tree_util.tree_map(lambda a: a[0], jt["blocks"][f"l{j}"]),
                                xj)
        with torch.inference_mode():
            got, _ = lm._apply_layer(cfg, tree_index(tt["blocks"][f"l{j}"], 0), kind, fk,
                                     torch.as_tensor(np.array(xj)),
                                     positions=torch.as_tensor(pos))
        assert _rel(got, want) < REL_L2_FLIP, (j, kind, fk)
        xj = want
    jh = jlm.L.norm(jt["final_norm"], xj)
    th = lm.L.norm(tt["final_norm"], torch.as_tensor(np.array(xj)))
    assert _rel(lm.L.dense(tt["lm_head"], th), jlm.L.dense(jt["lm_head"], jh)) < REL_L2


# ---------------------------------------------------------------------------
# planner, compiler, launches
# ---------------------------------------------------------------------------


def test_planner_sites_and_schedules_match_reference():
    """The site walk (names, dims, counts, representative slices: a Mamba
    layer's ``w_in``/``w_out``, a MoE layer's experts x groups) and the
    compiled schedules under a uniform and a fused W4A8 plan equal the
    reference's in every field but ``backend`` and ``tiles``."""
    jcfg, cfg, jp, tp = _setup()
    got, want = tpl.enumerate_sites(cfg, tp), jpl.enumerate_sites(jcfg, jp)
    assert [(s.site, s.d_in, s.d_out, s.count) for s in got] == \
        [(s.site, s.d_in, s.d_out, s.count) for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.weight.numpy(), np.asarray(w.weight))
    names = [s.site for s in got]
    assert "blocks.l0.mixer.w_in" in names and "blocks.l3.mixer.wq" in names
    for plan in (dict(FUSED, fuse=False), FUSED):
        want = jcomp.compile_schedule(jcfg, jplan_mod.PrecisionPlan(**plan))
        sched = compile_schedule(cfg, PrecisionPlan(**plan), backend="cpu")
        assert _strip(sched.canonical()) == _strip(want.canonical())


def test_launches_per_forward_counts_prefill_decode_and_scoring(monkeypatch):
    """Under the compiled fused W4A8 schedule: a prefill wave and each
    decode step launch 2 ``quant_matmul`` a Mamba layer (``w_xproj`` and
    ``w_dt`` stay float), the attention layer's 4 and the dense FFNs' 3
    (nothing fuses at smoke width but the attention's and the dense FFNs'
    groups), 3 batched launches a MoE layer, as the schedule predicts; a
    scoring forward adds the one two-stage launch."""
    _, cfg, _, tp = _setup()
    cfg = cfg.with_(attn_impl="two_stage")
    sched = compile_schedule(cfg, PrecisionPlan(**FUSED))
    params = quantize_lm(cfg, tp, sched)
    served = sched.launches_per_forward(two_stage_attention=False)
    assert served["quant_matmul_batched"] == 3 * 4
    mamba_sites = [s for s in sched.sites if s.site.rsplit(".", 1)[1] in ("w_in", "w_out")]
    assert len(mamba_sites) == 2 * 7 and all(s.fused_group is None for s in mamba_sites)
    _recording(monkeypatch)
    toks = torch.as_tensor(_tokens(n=12)).long()
    with torch.inference_mode():
        cache = lm.init_cache(cfg, 2, 16)
        with probe.tracking() as log:
            _, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill")
        assert log.by_name() == served
        assert sched.launches_per_forward(two_stage_attention=False, decode=True) == served
        for t in range(2):
            with probe.tracking() as log:
                lm.decode_step(cfg, params, toks[:, t], cache)
            assert log.by_name() == served, t
        with probe.tracking() as log:
            lm.forward(cfg, params, toks)
    assert log.by_name() == sched.launches_per_forward(two_stage_attention=True)
    assert log.by_name()["two_stage_attention"] == 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _prompts(vocab, n=4):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, (m,)).astype(np.int32) for m in (10, 7, 10, 7)[:n]]


def _hold(jeng, teng, want, got, tier, prompt):
    """A request's ids, token for token, or up to a rounding tie (W4A8
    only): teacher-forced on the reference's ids through the path the
    engines served it (a prefill left-padded to the prompt bucket, or at the
    exact length for a recurrent pattern, then decode steps over the cache),
    both trees pick their own engine's token where the ids part, those
    logits agree within the flip bound, and the reference scores the port's
    pick no lower than its own less the largest logit gap on that row."""
    if np.array_equal(want, got):
        return
    assert tier == "balanced", (want, got)
    t = int(np.argmax(want != got))
    jcfg, cfg = jeng.cfg, teng.cfg
    jt, tt = jeng.tier_params(tier), teng.tier_params(tier)
    width = teng.prompt_bucket(len(prompt)) if teng.pad_prompts else len(prompt)
    toks = np.pad(prompt, (width - len(prompt), 0))[None].astype(np.int32)
    pad = np.array([width - len(prompt)], np.int32) if teng.pad_prompts else None
    jc, tc = jlm.init_cache(jcfg, 1, width + t), lm.init_cache(cfg, 1, width + t)
    tpad = None if pad is None else torch.as_tensor(pad).long()
    jpad = None if pad is None else jnp.asarray(pad)
    jl, jc = _jforward(jcfg, "prefill")(jt, jnp.asarray(toks), jc, jpad)
    with torch.inference_mode():
        tl, tc = lm.forward(cfg, tt, torch.as_tensor(toks).long(), cache=tc, mode="prefill",
                            pad_lens=tpad)
        for s in range(t):
            jl, jc = _jforward(jcfg, "decode")(jt, jnp.asarray(want[None, s:s + 1]), jc, jpad)
            tl, tc = lm.decode_step(cfg, tt, torch.as_tensor(want[s:s + 1]).long(), tc,
                                    pad_lens=tpad)
    j_row, t_row = np.asarray(jl[0, -1]), tl[0, -1].numpy()
    assert j_row.argmax() == want[t] and t_row.argmax() == got[t], t
    assert _rel(t_row, j_row) < REL_L2_FLIP, t
    gap = np.abs(j_row - t_row).max()
    assert j_row[got[t]] >= j_row[want[t]] - gap, (t, gap)


def _engines(mode, slots=False, **kw):
    """Both engines with the two tiers; ``slots``: the continuous
    scheduler's settings (slot widths 1, 2, 4, 2 decode steps a poll).  The
    reference's ``balanced`` tier is its own ``quantize_lm`` output, jitted
    (``_trees``), put in its tier cache: its engine would run the walk
    eagerly, ~15 s at this size."""
    jcfg, cfg, jp, tp = _setup(**kw)
    args = dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0)
    if slots:
        args.update(max_batch=4, batch_buckets=(1, 2, 4), max_wait_s=0.0,
                    decode_steps_per_poll=2)
    jeng = JEngine(jcfg, jp, tiers={"quality": None, "balanced": jvq.W4A8}, mode=mode, **args)
    jeng._tierset._params["balanced"] = _trees("w4a8", **kw)[0]
    return (jeng, Engine(cfg, tp, tiers={"quality": None, "balanced": W4A8}, mode=mode,
                         device="cpu", **args))


def test_engine_serves_bucket_mode_as_the_reference():
    """``mode="auto"`` resolves to bucket mode on both sides (attention
    mixed with Mamba under one shared decode position) with the reason
    printed, ``mode="continuous"`` is refused, prompts keep their exact
    length; both tiers' ids equal the reference's (W4A8 up to a rounding
    tie, ``_hold``)."""
    jeng, teng = _engines("auto")
    assert not jeng.continuous and not teng.continuous and not teng.pad_prompts
    assert teng.stats.mode.startswith("bucket (mode='auto': pattern ('mamba', 'mamba', 'mamba', "
                                      "'attn',")
    with pytest.raises(ValueError, match="mode='continuous' needs"):
        _engines("continuous", slots=True)
    prompts = _prompts(get_config(ARCH).vocab_size)
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.enqueue(p, N_STEPS, tier=TIERS[i % 2]) for i, p in enumerate(prompts)]
        eng.flush()
        outs.append([np.asarray(r.result()) for r in reqs])
    assert {b.prompt_len for b in teng.stats.buckets if type(b).__name__ == "PrefillBucket"} \
        == {10, 7}
    for i, (w, g) in enumerate(zip(*outs)):
        assert g.dtype == np.int32 and g.shape == (N_STEPS,)
        _hold(jeng, teng, w, g, TIERS[i % 2], prompts[i])


def test_engine_serves_a_compiled_schedule():
    """``Engine(schedule=sched)`` (the fused W4A8 compile) gives the ids of
    the same plan served as a tier."""
    _, cfg, _, tp = _setup()
    sched = compile_schedule(cfg, PrecisionPlan(**FUSED))
    kw = dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0, device="cpu")
    prompts = np.stack(_prompts(cfg.vocab_size)[:1])
    got = Engine(cfg, tp, schedule=sched, **kw).generate(prompts, N_STEPS)
    want = Engine(cfg, tp, policy=PrecisionPlan(**FUSED), **kw).generate(prompts, N_STEPS)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pure_mamba_variant_serves_continuous_as_the_reference():
    """jamba-smoke ``with_(pattern=("mamba",), pos="none", moe=False)``,
    every layer a Mamba mixer on the dense FFN (the reference cannot stack a
    one-layer period whose FFN kind alternates, as ``moe_period`` 2 would
    make it): ``mode="auto"`` resolves to continuous on both sides, the
    port serves it through ``StateDecodeRunner`` at exact prompt lengths, a
    request joins mid-decode, and both tiers' ids equal the reference's
    continuous engine's (W4A8 up to a rounding tie)."""
    jeng, teng = _engines("auto", slots=True, pattern=("mamba",), pos="none", moe=False)
    assert jeng.continuous and teng.continuous and not teng.pad_prompts
    prompts = _prompts(get_config(ARCH).vocab_size)
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (0, 1)]
        eng.poll()
        reqs += [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (2, 3)]
        eng.flush()
        outs.append([np.asarray(r.result()) for r in reqs])
    assert all(isinstance(r, StateDecodeRunner) for r in teng._sched._runners.values())
    js, ts = jeng.stats.scheduler, teng.stats.scheduler
    assert ts.admitted_mid_decode >= 1
    assert (ts.admitted, ts.admitted_mid_decode) == (js.admitted, js.admitted_mid_decode)
    for i, (w, g) in enumerate(zip(*outs)):
        _hold(jeng, teng, w, g, TIERS[i % 2], prompts[i])
