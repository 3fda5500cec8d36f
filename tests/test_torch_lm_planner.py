"""The port's planner, compiler and tuner on the LM configs it serves
(``qwen3-14b-smoke``, ``rwkv6-1.6b-smoke``, ``deepseek-moe-16b-smoke``,
``phi3-mini-3.8b-smoke``, ``paligemma-3b-smoke``) against the JAX package's, on the reference's seed-0 weights carried across
by ``convert.py``: the site walk (names, dims, counts, representative
slices), the per-site scores, the greedy plan and its report, the proxy
logits error on the reference's own tokens; the compiled schedules, equal to
the reference's in every field but ``backend`` and ``tiles`` (the qwen3
golden and the reference's compile under uniform, fused, mixed and
split-``wk`` plans, fallback reasons included); the quantized tree a
schedule gives against its plan's; the launches a schedule predicts
against what a prefill wave, a decode step and a scoring forward launch;
the tuner's routed-expert signature; the launcher's refusals.  The MLA and
Mamba refusals of the planner and the compiler are cases of
``test_lm_branches_wait_for_the_lm_slice`` and
``test_lm_configs_wait_for_the_lm_slice``."""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.model_quant import quantize_lm as j_quantize_lm
from repro.core.precision import compiler as jcomp
from repro.core.precision import plan as jplan_mod
from repro.core.precision import planner as jpl
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.precision import (
    Autotuner, KernelSchedule, PrecisionPlan, TuningDB, compile_schedule,
)
from repro_torch.core.precision import planner as tpl
from repro_torch.core.precision import tuner as ttuner
from repro_torch.kernels import ops, probe
from repro_torch.kernels import quant_matmul as qm
from repro_torch.launch import compile as tcompile
from repro_torch.models import lm
from repro_torch.tree import tree_leaves
from test_torch_compiler import _strip
from test_torch_lm import REL_L2_FLIP, flatten_jax
from test_torch_precision import reference_constants  # noqa: F401 (a fixture)
from test_torch_schedule_serving import _recording

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "schedule_qwen3_smoke.json"
ARCHS = ("qwen3-14b-smoke", "rwkv6-1.6b-smoke", "deepseek-moe-16b-smoke",
         "phi3-mini-3.8b-smoke", "paligemma-3b-smoke")
# Relative tolerance of a site's error (and of the proxy logits error)
# against the reference's: the same float32 values quantized alike, the
# matmuls summed in another order.
REL_ERR = 1e-5
# How far the port's quantized logits may sit from the reference's on the
# proxy error's inputs (relative to the fp logits), against the nearer of
# the reference's own two executions of them, eager (as its
# ``proxy_recon_error`` runs) and jitted: where an int8 activation rounding
# sits within an ulp of its boundary, the summation order picks its side.
# On the reference's PRNGKey(0) tokens qwen3-14b-smoke reads 3.5-3.8e-7 at
# every level; deepseek-moe-16b-smoke 4e-7, although at W4A8 the
# reference's eager and jitted runs part by 3.0e-2 (a flip that moves one
# token to another expert): the port matches the jitted one.  rwkv6 W4A8
# and W8A8 part from both runs by 2.3e-3 and 4.4e-3 (one flip, carried on
# by the recurrence; W4A4 3.7e-7): the dense flip bound.  paligemma-3b-smoke
# (embedding inputs, the reference's jax.random.normal floats) W4A8 parts
# from both by 4.4e-4 (one flip): the dense flip bound too.
GAP_BOUND = {"qwen3-14b-smoke": REL_ERR, "rwkv6-1.6b-smoke": REL_L2_FLIP,
             "deepseek-moe-16b-smoke": REL_ERR, "phi3-mini-3.8b-smoke": REL_ERR,
             "paligemma-3b-smoke": REL_L2_FLIP}
PLANS = {
    "w4a8": dict(default="w4a8", use_kernel=True, fuse=False, name="w4a8"),
    "fused": dict(default="w4a8", use_kernel=True, fuse=True, name="w4a8"),
    "mixed": dict(default="w4a8", use_kernel=True, fuse=True, name="mixed",
                  overrides=(("*.wo", "bf16"), ("*ffn.w_down", "w8a8"))),
    "split": dict(default="w4a8", use_kernel=True, fuse=True, name="split",
                  overrides=(("*.wk", "w8a8"), ("*.ffn.w_up", "bf16"))),
}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_get_config(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config(arch), jp, params_from_numpy(flatten_jax(jp))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_enumerate_sites_matches_reference(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    got, want = tpl.enumerate_sites(cfg, tp), jpl.enumerate_sites(jcfg, jp)
    assert [(s.site, s.d_in, s.d_out, s.count) for s in got] == \
        [(s.site, s.d_in, s.d_out, s.count) for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.weight.numpy(), np.asarray(w.weight))
    if cfg.moe:  # an expert site counts scan groups x experts
        ex = next(s for s in got if ".ffn.experts." in s.site)
        assert ex.count == lm.n_scan_groups(cfg) * cfg.n_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_site_scores_match_reference(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    got, want = tpl.score_sites(cfg, tp), jpl.score_sites(jcfg, jp)
    assert [s.info.site for s in got] == [s.info.site for s in want]
    for g, w in zip(got, want):
        assert g.errors.keys() == w.errors.keys()
        for lv, e in w.errors.items():
            assert g.errors[lv] == pytest.approx(e, rel=REL_ERR, abs=1e-12), (g.info.site, lv)


@pytest.mark.parametrize("budget", [None, 1.6], ids=["default", "roomy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference(reference_constants, arch, budget):
    """The greedy plan and its report; ``roomy`` opens the weight budget to
    1.6x uniform W4A4, so w8a8 and bf16 islands appear as overrides."""
    jcfg, cfg, jp, tp = _setup(arch)
    kw = {}
    if budget is not None:
        kw["weight_bytes_budget"] = budget * tpl.uniform_weight_bytes(cfg, tp, "w4a4")
    plan, rep = tpl.plan_model(cfg, tp, **kw)
    jplan, jrep = jpl.plan_model(jcfg, jp, **kw)
    assert (plan.default, plan.overrides, plan.method, plan.name) == \
        (jplan.default, jplan.overrides, jplan.method, jplan.name)
    assert rep["level_counts"] == jrep["level_counts"]
    assert rep["weight_bytes"] == jrep["weight_bytes"]
    assert rep["assignment"] == jrep["assignment"]
    if budget is not None:
        assert plan.overrides, "the roomy budget buys no island"


def _rel_to(a, b, ref) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def _hold_proxy(jcfg, cfg, jp, tp, lv, x, bound, **kw):
    """The port's proxy error of uniform ``lv`` on the inputs ``x`` (numpy
    tokens or floats) against the reference's.  The port's quantized logits
    must lie within ``bound`` of the nearer of the reference's eager and
    jitted runs; the errors then agree to ``REL_ERR`` against that run's,
    outright where the gap is float noise (``<= REL_ERR``), else give or
    take the gap."""
    xj, tx = jnp.asarray(x), torch.as_tensor(x)
    tx = tx if tx.is_floating_point() else tx.long()
    ref = np.asarray(jlm.forward(jcfg, jp, xj)[0])
    jt = j_quantize_lm(jcfg, jp, jplan_mod.PrecisionPlan(default=lv))
    runs = [np.asarray(jlm.forward(jcfg, jt, xj)[0]),
            np.asarray(jax.jit(lambda p, v: jlm.forward(jcfg, p, v)[0])(jt, xj))]
    want_eager = jpl.proxy_recon_error(jcfg, jp, jplan_mod.PrecisionPlan(default=lv), **kw)
    assert _rel_to(runs[0], ref, ref) == pytest.approx(want_eager, rel=1e-6)
    got = tpl.proxy_recon_error(cfg, tp, PrecisionPlan(default=lv), inputs=tx)
    with torch.inference_mode():
        tq = lm.forward(cfg, quantize_lm(cfg, tp, PrecisionPlan(default=lv)), tx)[0].numpy()
    gaps = [_rel_to(tq, r, ref) for r in runs]
    i = int(np.argmin(gaps))
    gap, want = gaps[i], _rel_to(runs[i], ref, ref)
    assert gap <= bound, (lv, gaps, bound)
    slack = gap if gap > REL_ERR else 0.0
    assert abs(got - want) <= REL_ERR * want + slack, (lv, got, want, gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_proxy_recon_error_matches_reference_on_its_tokens(arch):
    """The reference draws its tokens (an ``embed_inputs`` config: its
    ``[B, T, d]`` floats) with ``jax.random``; the port takes the same
    inputs as ``inputs`` (``_hold_proxy``, ``GAP_BOUND``)."""
    jcfg, cfg, jp, tp = _setup(arch)
    if cfg.embed_inputs:
        toks = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 16, cfg.d_model),
                                          jnp.float32))
    else:
        toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 16), 0, jcfg.vocab_size))
    for lv in ("w4a8", "w4a4", "w8a8"):
        _hold_proxy(jcfg, cfg, jp, tp, lv, toks, GAP_BOUND[arch])
    g = tpl.proxy_recon_error(cfg, tp, PrecisionPlan(default="w4a4"),
                              torch.Generator().manual_seed(3))
    assert g == tpl.proxy_recon_error(cfg, tp, PrecisionPlan(default="w4a4"),
                                      torch.Generator().manual_seed(3))
    # bf16 sites fold the rotations into float32 weights: rounding only
    assert tpl.proxy_recon_error(cfg, tp, PrecisionPlan(default="bf16")) < 1e-5


def test_proxy_recon_error_takes_embedding_inputs():
    """An ``embed_inputs`` config on the reference's own ``[B, T, d]``
    floats (``jax.random.normal``, PRNGKey(0)), given to both sides.  W8A8
    flips a rounding against both of the reference's runs (3.5e-3 of the
    error): the dense flip bound."""
    jcfg = j_get_config("qwen3-14b-smoke").with_(embed_inputs=True)
    cfg = get_config("qwen3-14b-smoke").with_(embed_inputs=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(flatten_jax(jp))
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, 8, cfg.d_model), jnp.float32))
    for lv in ("w4a8", "w8a8"):
        _hold_proxy(jcfg, cfg, jp, tp, lv, x, REL_L2_FLIP, batch=1, tokens=8)


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


def test_fused_schedule_equals_the_qwen3_golden_but_backend_and_tiles():
    sched = compile_schedule(get_config("qwen3-14b-smoke"), PrecisionPlan(**PLANS["fused"]))
    golden = json.loads(GOLDEN.read_text())
    assert _strip(sched.canonical()) == _strip(golden)
    assert golden["backend"] == "interpret"
    assert KernelSchedule.load(GOLDEN).hash == jcomp.KernelSchedule.load(str(GOLDEN)).hash


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_equals_the_references_compile(arch, plan):
    want = jcomp.compile_schedule(j_get_config(arch), jplan_mod.PrecisionPlan(**PLANS[plan]))
    got = compile_schedule(get_config(arch), PrecisionPlan(**PLANS[plan]), backend="cpu")
    assert _strip(got.canonical()) == _strip(want.canonical())
    assert got.summary() == want.summary()
    assert (got.attention is None) == ("attn" not in get_config(arch).pattern)


def test_fallback_reasons_match_at_qwen3_and_deepseek_widths():
    """At full width qwen3-14b's W4 QKV panel (5120 x 7168 / 2) is over the
    8 MiB budget, so nothing fuses; deepseek-moe-16b's (2048 x 6144 / 2)
    fuses, and its dense layer 0's FFN (d_ff 10,944) falls back."""
    plan = PrecisionPlan(**PLANS["fused"])
    cfg = get_config("qwen3-14b").with_(n_layers=2)
    want = jcomp.compile_schedule(j_get_config("qwen3-14b").with_(n_layers=2),
                                  jplan_mod.PrecisionPlan(**PLANS["fused"]))
    got = compile_schedule(cfg, plan)
    assert _strip(got.canonical()) == _strip(want.canonical())
    reasons = {s.site: s.fallback for s in got.sites}
    assert reasons["blocks.l0.mixer.wq"] == "qkv panel exceeds fused VMEM budget"
    assert reasons["blocks.l0.ffn.w_up"] == "ffn panel exceeds fused VMEM budget"
    assert not got.groups and got.site("blocks.l0.mixer.wo").epilogue is None
    ds = compile_schedule(get_config("deepseek-moe-16b").with_(n_layers=2), plan)
    assert [g.name for g in ds.groups] == ["prefix.0.mixer.wqkv", "blocks.l0.mixer.wqkv"]
    assert all(g.wo_epilogue for g in ds.groups)
    assert ds.site("prefix.0.ffn.w_up").fallback == "ffn panel exceeds fused VMEM budget"
    assert ds.launches_per_forward(two_stage_attention=False) == {
        "fused_matmul": 4, "quant_matmul": 6, "quant_matmul_batched": 3}


@pytest.mark.parametrize("plan", ["fused", "split"])
@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_quantizes_as_the_plan(arch, plan):
    """``quantize_lm`` through a compiled schedule equals the implicit
    path's tree leaf for leaf, and every site carries the schedule's
    tiles."""
    _, cfg, _, tp = _setup(arch)
    p = PrecisionPlan(**PLANS[plan])
    sched = compile_schedule(cfg, p)
    implicit, compiled = quantize_lm(cfg, tp, p), quantize_lm(cfg, tp, sched)
    la, lb = tree_leaves(implicit), tree_leaves(compiled)
    assert len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    mx = compiled["blocks"]["l0"]["mixer"]
    for name, leaf in mx.items():
        if getattr(leaf, "tiles", None) is not None:
            want = sched.fuse_decision("blocks.l0.mixer.wqkv")[1].tiles if name == "wqkv" \
                else sched.tiles_for(f"blocks.l0.mixer.{name}")
            assert leaf.tiles == want, name
    if cfg.moe:
        ex = compiled["blocks"]["l0"]["ffn"]["experts"]["w_up"]
        assert dict(ex.tiles) == qm.LAUNCH_TILES


@pytest.mark.parametrize("plan", ["w4a8", "fused", "mixed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launches_per_forward_counts_prefill_decode_and_scoring(monkeypatch, arch, plan):
    """A left-padded prefill wave and each decode step launch what
    ``launches_per_forward(two_stage_attention=False)`` says (batched expert
    launches included); a scoring forward with two-stage attention what
    ``two_stage_attention=True`` says."""
    _, cfg, _, tp = _setup(arch)
    cfg = cfg.with_(attn_impl="two_stage")
    sched = compile_schedule(cfg, PrecisionPlan(**PLANS[plan]))
    params = quantize_lm(cfg, tp, sched)
    _recording(monkeypatch)
    rng = np.random.default_rng(1)
    toks = (torch.as_tensor(rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32))
            if cfg.embed_inputs else torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12))).long())
    attn = "attn" in cfg.pattern
    pad = torch.tensor([0, 3]) if attn else None
    served = sched.launches_per_forward(two_stage_attention=False)
    with torch.inference_mode():
        cache = lm.init_cache(cfg, 2, 16)
        with probe.tracking() as log:
            _, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill", pad_lens=pad)
        assert log.by_name() == served
        for t in range(2):
            with probe.tracking() as log:
                lm.decode_step(cfg, params, toks[:, t:t + 1] if cfg.embed_inputs else toks[:, t],
                               cache, pad_lens=pad)
            assert log.by_name() == served, t
        with probe.tracking() as log:
            lm.forward(cfg, params, toks)
    assert log.by_name() == sched.launches_per_forward(two_stage_attention=True)
    if cfg.moe:
        assert served["quant_matmul_batched"] == 3 * (cfg.n_layers - cfg.first_dense)


# ---------------------------------------------------------------------------
# the tuner's routed-expert signature
# ---------------------------------------------------------------------------


def test_expert_sites_tune_the_batched_launch(tmp_path):
    cfg = get_config("deepseek-moe-16b-smoke")
    plan = PrecisionPlan(**PLANS["fused"])
    db = str(tmp_path / "tune.json")
    t1 = Autotuner(db=TuningDB(db), device="cpu")
    s1 = compile_schedule(cfg, plan, tuner=t1)
    e, k, n = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    key = ttuner.batched_key(k, n, experts=e, w_bits=4, a_bits=8, packed=True, backend="cpu")
    assert t1.db.entries[key]["cost"] == qm.batched_function_bytes(
        e, e, ttuner.TUNE_EXPERT_M, k, n, packed=True)
    assert t1.db.entries[key]["tiles"] == qm.LAUNCH_TILES == ops.launch_tiles("quant_matmul")
    assert dict(s1.site("blocks.l0.ffn.experts.w_up").tiles) == qm.LAUNCH_TILES
    t2 = Autotuner(db=TuningDB(db), device="cpu")
    s2 = compile_schedule(cfg, plan, tuner=t2)
    assert t2.timing_runs == 0 and t2.db.misses == 0 and s2.hash == s1.hash
    kinds = []
    t3 = Autotuner(db=TuningDB(), measure=lambda kind, tiles: kinds.append(kind) or 1.0)
    compile_schedule(cfg, plan, tuner=t3)
    assert "quant_matmul_batched" in kinds and t3.backend == "cuda"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b-smoke", "jamba-v0.1-52b",
                                  "starcoder2-7b"])
def test_launcher_refuses_unported_arches(capsys, arch):
    """The reference's other configs are not in the port's registry: exit 2
    with its error, which points to ROADMAP.md queue 1 (MLA and Mamba
    configs are refused by kind in the planner and the compiler,
    ``test_lm_branches_wait_for_the_lm_slice`` and
    ``test_lm_configs_wait_for_the_lm_slice``)."""
    with pytest.raises(SystemExit) as e:
        tcompile.main(["--device", "cpu", "--arch", arch])
    err = capsys.readouterr().err
    assert e.value.code == 2 and f"unknown arch {arch!r}" in err
    assert "ROADMAP.md queue 1 (items 7b, 7c and 9)" in err
