"""The port's precision planner against the JAX package's, at
``vggt-1b-smoke`` with the reference's weights carried across by
``convert.py``: the plan model's helpers, site enumeration, per-site,
per-level scores (the synthetic activations are the reference's bit for
bit), the modeled costs, and the greedy plan — equal under the reference's
roofline constants, pinned under the port's H100 constants."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.precision import plan as jplan_mod
from repro.core.precision import planner as jpl
from repro.launch import roofline_util as jroof
from repro.models import vggt as jvggt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import PrecisionPlan, plan as plan_mod
from repro_torch.core.precision import planner as tpl
from repro_torch.launch import roofline_util
from repro_torch.models import lm as tlm
from test_torch_vggt import flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# Relative tolerance of a site's error at a level against the reference's:
# both quantize the same float32 values, and the matmuls sum in another
# order (~3e-7 relative observed at this seed).
REL_ERR = 1e-5
LEVELS = ("bf16", "w8a8", "w4a8", "w4a4", "w4a16", "w2a8")


@functools.lru_cache(maxsize=1)
def _setup():
    jcfg = j_get_config("vggt-1b-smoke")
    cfg = get_config("vggt-1b-smoke")
    jp = jvggt.init_params(jcfg, jax.random.PRNGKey(0))
    jplan, jrep = jpl.plan_model(jcfg, jp)
    return jcfg, cfg, jp, params_from_numpy(flatten_jax(jp)), jplan, jrep


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's planner budgeting against the reference's constants."""
    monkeypatch.setattr(tpl, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tpl, "HBM_BW", jroof.HBM_BW)


def _plan_fields(p):
    return (p.default, p.overrides, p.method, p.use_kernel, p.fuse, p.name)


@pytest.mark.parametrize("level", LEVELS)
def test_level_weight_bits_matches(level):
    assert plan_mod.level_weight_bits(level) == jplan_mod.level_weight_bits(level)


def test_plan_helpers_match():
    kw = dict(default="w4a8", overrides=(("*.wo", "bf16"),), method="rtn", name="x")
    got, want = PrecisionPlan(**kw), jplan_mod.PrecisionPlan(**kw)
    assert got.tag == want.tag == "x(rtn,w4a8+1)"
    got2, want2 = got.with_override("frame.*", "w8a8"), want.with_override("frame.*", "w8a8")
    assert _plan_fields(got2) == _plan_fields(want2)
    sites = [s.site for s in tpl.enumerate_sites(*_setup()[1:4:2])]
    assert got2.levels_used(sites) == want2.levels_used(sites)
    assert sum(got2.levels_used(sites).values()) == 12


def test_roofline_constants_are_the_h100s():
    assert (roofline_util.PEAK_FLOPS, roofline_util.HBM_BW) == (1979e12, 3.35e12)
    assert (tpl.PEAK_FLOPS, tpl.HBM_BW) == (roofline_util.PEAK_FLOPS, roofline_util.HBM_BW)


def test_enumerate_sites_matches():
    jcfg, cfg, jp, tp, _, _ = _setup()
    got, want = tpl.enumerate_sites(cfg, tp), jpl.enumerate_sites(jcfg, jp)
    assert [(s.site, s.d_in, s.d_out, s.count) for s in got] == \
        [(s.site, s.d_in, s.d_out, s.count) for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.weight.numpy(), np.asarray(w.weight))
    for level in ("w4a4", "w8a8", "bf16"):
        assert tpl.uniform_weight_bytes(cfg, tp, level) == jpl.uniform_weight_bytes(jcfg, jp, level)


def test_synthetic_activations_are_the_references():
    for site, d in (("frame.attn.wq", 128), ("global.ffn.w_down", 256)):
        np.testing.assert_array_equal(tpl._synthetic_activations(site, d, 64),
                                      np.asarray(jpl._synthetic_activations(site, d, 64)))


def test_site_errors_match_reference():
    """Per-site, per-level relative errors of the quantized matmul against
    the reference's ``score_sites`` (read off its plan report)."""
    _, cfg, _, tp, _, jrep = _setup()
    scored = tpl.score_sites(cfg, tp)
    assert [s.info.site for s in scored] == list(jrep["site_errors"])
    worst = 0.0
    for s in scored:
        want = jrep["site_errors"][s.info.site]
        assert set(s.errors) == set(want)
        for level, e in s.errors.items():
            if want[level] == 0.0:
                assert e == 0.0
                continue
            worst = max(worst, abs(e - want[level]) / want[level])
    assert worst < REL_ERR, worst


@pytest.mark.parametrize("level", ["bf16", "w8a8", "w4a8", "w4a4"])
def test_modeled_costs_match(reference_constants, level):
    jcfg, cfg, jp, tp, _, _ = _setup()
    for g, w in zip(tpl.enumerate_sites(cfg, tp), jpl.enumerate_sites(jcfg, jp)):
        assert tpl._rate_multiplier(level) == jpl._rate_multiplier(level)
        assert tpl.site_weight_bytes(g, level) == jpl.site_weight_bytes(w, level)
        assert tpl.site_latency_s(g, level, 4096) == pytest.approx(
            jpl.site_latency_s(w, level, 4096), rel=1e-12)


def test_plan_matches_reference_under_its_constants(reference_constants):
    _, cfg, _, tp, jplan, jrep = _setup()
    plan, rep = tpl.plan_model(cfg, tp)
    assert _plan_fields(plan) == _plan_fields(jplan)
    assert rep["level_counts"] == jrep["level_counts"]
    assert rep["assignment"] == jrep["assignment"]
    for k in ("weight_bytes", "weight_bytes_budget", "modeled_latency_s", "latency_budget_s"):
        assert rep[k] == pytest.approx(jrep[k], rel=1e-9), k


def test_plan_under_the_h100_constants_is_pinned():
    """At smoke widths the sites sit near the H100's ridge (~500 int8
    operations a byte against 590), so this plan differs from the
    reference's; it is pinned as it reads."""
    _, cfg, _, tp, jplan, _ = _setup()
    plan, rep = tpl.plan_model(cfg, tp, use_kernel=True, fuse=True)
    assert rep["level_counts"] == {"w4a4": 9, "w4a8": 3}
    assert plan.default == "w4a4" and plan.use_kernel and plan.fuse
    assert plan.overrides == (("frame.ffn.w_up", "w4a8"), ("global.attn.wo", "w4a8"),
                              ("global.ffn.w_up", "w4a8"))
    assert plan.overrides != jplan.overrides


def test_budgets_open_high_precision_as_the_reference(reference_constants):
    jcfg, cfg, jp, tp, _, _ = _setup()
    budget = 2.0 * jpl.uniform_weight_bytes(jcfg, jp, "w4a4")
    jplan, jrep = jpl.plan_model(jcfg, jp, weight_bytes_budget=budget, latency_budget_s=1.0)
    plan, rep = tpl.plan_model(cfg, tp, weight_bytes_budget=budget, latency_budget_s=1.0)
    assert _plan_fields(plan) == _plan_fields(jplan)
    assert rep["level_counts"] == jrep["level_counts"]


def test_latency_from_stats_matches(reference_constants):
    from repro.serving.batching import ServeStats as JStats
    from repro.serving.vggt_engine import Bucket as JBucket
    from repro_torch.serving.batching import ServeStats
    from repro_torch.serving.vggt_engine import Bucket

    jcfg, cfg, jp, tp, _, _ = _setup()
    stats, jstats = ServeStats(), JStats()
    for st, b in ((stats, Bucket(2, 2, 16)), (jstats, JBucket(2, 2, 16))):
        bs = st.bucket(b)
        bs.calls, bs.items, bs.total_s = 3, 6, 0.3
        bs.latencies_s.extend([0.1, 0.1, 0.1])
    with pytest.raises(ValueError) as got:
        tpl.site_latency_from_stats(stats, cfg, tp)
    with pytest.raises(ValueError) as want:
        jpl.site_latency_from_stats(jstats, jcfg, jp)
    assert str(got.value) == str(want.value)
    fn = tpl.site_latency_from_stats(stats, cfg, tp, tokens=42)
    jfn = jpl.site_latency_from_stats(jstats, jcfg, jp, tokens=42)
    assert fn.scale == pytest.approx(jfn.scale, rel=1e-12)
    plan, _ = tpl.plan_model(cfg, tp, site_latency_fn=fn, tokens=42)
    jplan, _ = jpl.plan_model(jcfg, jp, site_latency_fn=jfn, tokens=42)
    assert _plan_fields(plan) == _plan_fields(jplan)


def test_proxy_recon_error_orders_the_levels():
    _, cfg, _, tp, _, _ = _setup()
    g = torch.Generator().manual_seed(3)
    errs = {lv: tpl.proxy_recon_error(cfg, tp, PrecisionPlan(default=lv),
                                      torch.Generator().manual_seed(3))
            for lv in ("bf16", "w8a8", "w4a4")}
    # bf16 sites are exact up to float32 rounding; fewer bits, more error
    assert errs["bf16"] < 1e-6 < errs["w8a8"] < errs["w4a4"], errs
    assert tpl.proxy_recon_error(cfg, tp, PrecisionPlan(default="w4a4"), g) == errs["w4a4"]


@pytest.mark.parametrize("kw,item", [({}, None), (dict(mla=True), "item 7b"),
                                     (dict(pattern=("attn", "mamba"), n_layers=4), "item 9")],
                         ids=["gqa", "mla", "mamba"])
def test_lm_branches_wait_for_the_lm_slice(kw, item):
    """The LM slice has landed for every layer kind (rwkv, MoE, MLA and
    Mamba stacks held against the reference in
    ``tests/test_torch_lm_planner.py`` and ``tests/test_torch_zoo_jamba.py``):
    the site walk and the proxy error run; a Mamba layer's sites are
    ``w_in`` and ``w_out``."""
    cfg = get_config("qwen3-14b-smoke").with_(**kw)
    if item == "item 7b":  # ported: deepseek-v2-lite-16b-smoke's MLA
        cfg = get_config("deepseek-v2-lite-16b-smoke")
        params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
        sites = tpl.enumerate_sites(cfg, params)
        assert [s.site for s in sites[:5]] == [f"prefix.0.mixer.{n}" for n in
                                               ("wq", "w_kv_down", "w_k_up", "w_v_up", "wo")]
        assert [(s.d_in, s.d_out) for s in sites[1:3]] == [(128, 80), (64, 128)]
        assert 0.0 < tpl.proxy_recon_error(cfg, params, PrecisionPlan(default="w4a8")) < 1.0
        return
    if item is None:
        params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
        sites = tpl.enumerate_sites(cfg, params)
        assert [s.site for s in sites[:4]] == [f"blocks.l0.mixer.{n}" for n in
                                               ("wq", "wk", "wv", "wo")]
        assert all(s.count == cfg.n_layers for s in sites)
        assert 0.0 < tpl.proxy_recon_error(cfg, params, PrecisionPlan(default="w4a8")) < 1.0
        return
    # item 9, ported: the Mamba layer's two sites
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    sites = tpl.enumerate_sites(cfg, params)
    assert [s.site for s in sites if ".mixer." in s.site] == [
        f"blocks.l0.mixer.{n}" for n in ("wq", "wk", "wv", "wo")] + [
        "blocks.l1.mixer.w_in", "blocks.l1.mixer.w_out"]
    di = cfg.mamba_expand * cfg.d_model
    assert [(s.d_in, s.d_out, s.count) for s in sites if ".mixer.w_" in s.site] == [
        (cfg.d_model, 2 * di, 2), (di, cfg.d_model, 2)]
    assert 0.0 < tpl.proxy_recon_error(cfg, params, PrecisionPlan(default="w4a8")) < 1.0
