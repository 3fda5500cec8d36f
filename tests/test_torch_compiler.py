"""The port's kernel-plan compiler and tuner against the JAX package's, at
``vggt-1b-smoke``: the compiled schedule equals the reference's in every
field but ``backend`` and ``tiles`` (the pinned golden, and the reference's
own compile for mixed plans, fallback reasons included); its hash, JSON and
version gate; quantize parity through a schedule; the launch tiles it
carries, read off ``csrc/``; the wrappers refusing tiles their kernel
cannot launch; the tuning DB's cache hits and the injectable measure."""
import dataclasses
import functools
import json
import os
import pathlib
import re

import jax
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.precision import compiler as jcomp
from repro.core.precision import plan as jplan_mod
from repro.core.precision import planner as jpl
from repro.launch import roofline_util as jroof
from repro.models import vggt as jvggt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.model_quant import quantize_vggt
from repro_torch.core.precision import (
    Autotuner, KernelSchedule, PrecisionPlan, TuningDB, compile_schedule,
)
from repro_torch.core.precision import planner as tpl
from repro_torch.core.precision import tuner as ttuner
from repro_torch.core.quantize import quantize_weight
from repro_torch.core.versaq import QuantLinear
from repro_torch.kernels import fused as fz
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import two_stage_attention as tsa
from repro_torch.models import vggt as tvggt
from repro_torch.tree import tree_leaves
from test_torch_vggt import flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "schedule_vggt_smoke.json"
CSRC = ROOT / "src" / "repro_torch" / "csrc"

PLANS = {
    "w4a8": dict(default="w4a8", use_kernel=True, fuse=False, name="w4a8"),
    "fused": dict(default="w4a8", use_kernel=True, fuse=True, name="w4a8"),
    "mixed": dict(default="w4a8", use_kernel=True, fuse=True, name="mixed",
                  overrides=(("*.wo", "bf16"), ("*ffn.w_down", "w8a8"))),
    "split": dict(default="w4a8", use_kernel=True, fuse=True, name="split",
                  overrides=(("*.wk", "w8a8"), ("frame.ffn.w_up", "bf16"))),
    "emulated": dict(default="w4a4", use_kernel=False, fuse=False, name="emu",
                     overrides=(("global.*", "w8a8"),)),
}


def _plans(name):
    return jplan_mod.PrecisionPlan(**PLANS[name]), PrecisionPlan(**PLANS[name])


def _strip(canonical: dict) -> dict:
    """A schedule's canonical form without ``backend`` and ``tiles``."""
    d = json.loads(json.dumps(canonical))
    d.pop("backend")
    for entry in d["sites"] + d["groups"]:
        entry.pop("tiles")
    if d["attention"] is not None:
        d["attention"].pop("tiles")
    return d


@functools.lru_cache(maxsize=1)
def _weights():
    cfg = get_config("vggt-1b-smoke")
    jp = jvggt.init_params(j_get_config("vggt-1b-smoke"), jax.random.PRNGKey(0))
    return cfg, jp, params_from_numpy(flatten_jax(jp))


# ---------------------------------------------------------------------------
# the schedule against the reference's
# ---------------------------------------------------------------------------


def test_fused_schedule_equals_the_golden_but_backend_and_tiles():
    cfg = get_config("vggt-1b-smoke")
    sched = compile_schedule(cfg, PrecisionPlan(**PLANS["fused"]))
    golden = json.loads(GOLDEN.read_text())
    assert _strip(sched.canonical()) == _strip(golden)
    assert sched.backend == "cuda" and golden["backend"] == "interpret"


def test_golden_hash_equals_the_references():
    assert KernelSchedule.load(GOLDEN).hash == jcomp.KernelSchedule.load(str(GOLDEN)).hash


@pytest.mark.parametrize("name", list(PLANS))
def test_schedule_equals_the_references_compile(name):
    """Kernel choices, fusion groups, descriptors and fallback reasons
    equal the reference's for uniform, mixed and emulated plans."""
    jplan, plan = _plans(name)
    want = jcomp.compile_schedule(j_get_config("vggt-1b-smoke"), jplan)
    got = compile_schedule(get_config("vggt-1b-smoke"), plan, backend="cpu")
    assert _strip(got.canonical()) == _strip(want.canonical())
    assert got.summary() == want.summary()


def test_fallback_reasons_match_for_a_mixed_plan():
    jplan, plan = _plans("split")
    want = jcomp.compile_schedule(j_get_config("vggt-1b-smoke"), jplan)
    got = compile_schedule(get_config("vggt-1b-smoke"), plan)
    reasons = {s.site: s.fallback for s in got.sites if s.fallback}
    assert reasons == {s.site: s.fallback for s in want.sites if s.fallback}
    assert reasons["frame.attn.wq"] == "qkv members differ in precision/mode"
    assert reasons["frame.ffn.w_up"] == "bf16 member keeps ffn per-site"
    assert [g.name for g in got.groups] == [g.name for g in want.groups] == ["global.ffn"]


def test_planned_schedule_equals_the_references_compile(monkeypatch):
    """The planner's plan (under the reference's constants) compiles to
    the reference's schedule of the same plan."""
    cfg, jp, tp = _weights()
    jcfg = j_get_config("vggt-1b-smoke")
    monkeypatch.setattr(tpl, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tpl, "HBM_BW", jroof.HBM_BW)
    plan, _ = tpl.plan_model(cfg, tp, fuse=True, use_kernel=True, name="plan")
    jplan, _ = jpl.plan_model(jcfg, jp, fuse=True, use_kernel=True, name="plan")
    assert _strip(compile_schedule(cfg, plan).canonical()) == \
        _strip(jcomp.compile_schedule(jcfg, jplan).canonical())


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------


def test_schedule_json_round_trip_and_save_load(tmp_path):
    sched = compile_schedule(get_config("vggt-1b-smoke"), PrecisionPlan(**PLANS["mixed"]))
    again = KernelSchedule.from_json(sched.to_json())
    assert again.canonical() == sched.canonical() and again.hash == sched.hash
    assert again.plan.overrides == sched.plan.overrides and again.fuse and again.use_kernel
    path = tmp_path / "s.json"
    sched.save(path)
    assert KernelSchedule.load(path).hash == sched.hash
    assert sched.tag == f"sched:{sched.plan.tag}@{sched.hash[:8]}"


def test_schedule_version_gate():
    blob = json.loads(GOLDEN.read_text())
    blob["version"] = 999
    with pytest.raises(ValueError, match="version"):
        KernelSchedule.from_json(json.dumps(blob))


def test_a_reference_schedule_is_refused_for_serving():
    golden = KernelSchedule.load(GOLDEN)
    with pytest.raises(ValueError, match="recompile it with python -m repro_torch.launch.compile"):
        golden.check_servable()
    cfg, _, tp = _weights()
    with pytest.raises(ValueError, match="'interpret'"):
        quantize_vggt(cfg, tp, golden)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


def test_abstract_init_has_the_real_shapes():
    """The lowering's abstract init: ``init_params`` on ``meta``, the real
    init's shapes and dtypes, no storage."""
    cfg = get_config("vggt-1b-smoke")
    real = tree_leaves(tvggt.init_params(cfg, torch.Generator().manual_seed(0)))
    meta = tree_leaves(tvggt.init_params(cfg, torch.Generator(), device="meta"))
    assert [(t.shape, t.dtype) for t in real] == [(t.shape, t.dtype) for t in meta]
    assert all(t.device.type == "meta" for t in meta)


@pytest.mark.parametrize("name", ["w4a8", "fused", "mixed", "split"])
def test_schedule_quantizes_as_the_plan(name):
    """The tree quantized through a compiled schedule equals the implicit
    path's leaf for leaf; only the tile tuples differ."""
    cfg, _, tp = _weights()
    plan = PrecisionPlan(**PLANS[name])
    sched = compile_schedule(cfg, plan)
    implicit, compiled = quantize_vggt(cfg, tp, plan), quantize_vggt(cfg, tp, sched)
    la, lb = tree_leaves(implicit), tree_leaves(compiled)
    assert len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    for blk in ("frame", "global"):
        at = compiled["blocks"][blk]["attn"]
        assert set(at) == set(implicit["blocks"][blk]["attn"])
        for site, leaf in at.items():
            if isinstance(leaf, QuantLinear):
                want = sched.fuse_decision(f"{blk}.attn.wqkv")[1].tiles if site == "wqkv" \
                    else sched.tiles_for(f"{blk}.attn.{site}")
                assert leaf.tiles == want


@pytest.mark.parametrize("kw,item", [({}, None), (dict(mla=True), "item 7b"),
                                     (dict(pattern=("attn", "mamba"), n_layers=4), "item 9")],
                         ids=["gqa", "mla", "mamba"])
def test_lm_configs_wait_for_the_lm_slice(kw, item):
    """The LM lowering has landed for every layer kind (rwkv, MoE, MLA and
    Mamba stacks held against the reference in
    ``tests/test_torch_lm_planner.py`` and ``tests/test_torch_zoo_jamba.py``):
    an MLA stack lowers its five sites per-site, never fused; a Mamba layer
    its ``w_in``/``w_out`` plain, 2 ``quant_matmul`` a forward."""
    cfg = get_config("qwen3-14b-smoke").with_(**kw)
    if item == "item 7b":  # ported: deepseek-v2-lite-16b-smoke's MLA
        cfg = get_config("deepseek-v2-lite-16b-smoke")
        assert cfg.mla
        sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True))
        mixer = [s for s in sched.sites if s.site.startswith("blocks.l0.mixer.")]
        assert [s.site.rsplit(".", 1)[1] for s in mixer] == ["wq", "w_kv_down", "w_k_up",
                                                              "w_v_up", "wo"]
        assert all(s.kernel == "matmul" and s.fused_group is None for s in mixer)
        assert not any(g.kind == "qkv" for g in sched.groups)
        return
    if item is None:
        sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True))
        assert [g.name for g in sched.groups] == ["blocks.l0.mixer.wqkv", "blocks.l0.ffn"]
        assert dict(sched.attention.tiles) == tsa.LAUNCH_TILES
        return
    # item 9, ported: the Mamba layer's two sites, never fused
    sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True))
    mixer = [s for s in sched.sites if s.site.startswith("blocks.l1.mixer.")]
    assert [s.site.rsplit(".", 1)[1] for s in mixer] == ["w_in", "w_out"]
    assert all(s.kernel == "matmul" and s.fused_group is None for s in mixer)
    assert [g.name for g in sched.groups] == ["blocks.l0.mixer.wqkv", "blocks.l0.ffn",
                                              "blocks.l1.ffn"]
    assert sched.launches_per_forward(two_stage_attention=False) == {
        "fused_matmul": 2 * 2, "fused_ffn": 2 * 2, "quant_matmul": 2 * 2}


# ---------------------------------------------------------------------------
# launch tiles
# ---------------------------------------------------------------------------


def _const(text: str, name: str) -> int:
    """Evaluate ``constexpr int NAME = <expr>;`` of a CUDA source."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    expr = re.sub(r"\b([A-Z_]+)\b", lambda m: str(_const(text, m.group(1))), expr)
    return int(eval(expr))  # integer arithmetic on the source's constants only


def test_launch_tiles_are_the_csrc_constants():
    qmc = (CSRC / "quant_matmul.cu").read_text()
    assert qm.LAUNCH_TILES == {"bm": _const(qmc, "BM"), "bn": _const(qmc, "BN"),
                               "bk": int(re.search(r"static constexpr int BK = (\d+);", qmc)[1])}
    tsc = (CSRC / "two_stage_attention.cu").read_text()
    assert tsa.LAUNCH_TILES == {"bq": _const(tsc, "BQ"), "bk": _const(tsc, "BKT"),
                                "bkv": _const(tsc, "TV_TILES") * _const(tsc, "BKT")}
    rows = (CSRC / "fused_rows.cuh").read_text()
    assert "constexpr int BM = FT_BM;" in (CSRC / "fused_ffn.cu").read_text()
    assert "constexpr int BM = FT_BM;" in (CSRC / "fused_matmul.cu").read_text()
    want = {"bm": _const(rows, "FT_BM"), "bn": _const(rows, "FT_BN")}
    assert fz.MATMUL_TILES == fz.FFN_TILES == want


def test_schedule_tiles_are_the_kernels_launch_tiles():
    sched = compile_schedule(get_config("vggt-1b-smoke"), PrecisionPlan(**PLANS["split"]))
    for s in sched.sites:
        if s.kernel in ("fp", "emulation"):
            assert s.tiles is None, s.site
        elif s.kernel == "matmul":
            kernel = "fused_matmul" if s.prologue or s.epilogue else "quant_matmul"
            assert dict(s.tiles) == ops.launch_tiles(kernel), s.site
    for g in sched.groups:
        assert dict(g.tiles) == ops.launch_tiles("fused_ffn" if g.kind == "ffn" else "fused_matmul")
    assert dict(sched.attention.tiles) == tsa.LAUNCH_TILES
    emulated = compile_schedule(get_config("vggt-1b-smoke"), PrecisionPlan(**PLANS["emulated"]))
    assert all(s.tiles is None for s in emulated.sites)


TPU_TILES = {"quant_matmul": {"bm_target": 256, "bn": 128, "bk": 128},
             "two_stage_attention": {"bq_target": 64, "bk_target": 64, "bkv_target": 2048},
             "fused_matmul": {"bm_target": 256}, "fused_ffn": {"bm": 128}}


@pytest.mark.parametrize("kernel", list(TPU_TILES))
def test_launch_tiles_refuse_what_the_kernel_cannot_launch(kernel):
    fixed = ops.launch_tiles(kernel)
    assert ops.launch_tiles(kernel, tuple(fixed.items())) == fixed
    assert ops.launch_tiles(kernel, {k: fixed[k] for k in list(fixed)[:1]}) == fixed
    with pytest.raises(ValueError, match=f"{kernel}: cannot launch tiles"):
        ops.launch_tiles(kernel, TPU_TILES[kernel])


def test_wrappers_raise_for_foreign_tiles_and_run_with_their_own():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 64), generator=g)
    wq = quantize_weight(torch.randn((64, 128), generator=g), 4)
    want = ops.quant_linear_matmul(x, wq)
    assert torch.equal(ops.quant_linear_matmul(x, wq, tiles=qm.LAUNCH_TILES), want)
    with pytest.raises(ValueError, match="quant_matmul: cannot launch"):
        ops.quant_linear_matmul(x, wq, tiles=TPU_TILES["quant_matmul"])
    q = torch.randn((1, 2, 16, 32), generator=g)
    ops.two_stage_mha(q, q, q, tiles=tuple(tsa.LAUNCH_TILES.items()))
    with pytest.raises(ValueError, match="two_stage_attention: cannot launch"):
        ops.two_stage_mha(q, q, q, tiles=TPU_TILES["two_stage_attention"])
    site = QuantLinear(qw=wq, use_kernel=True, idct=True,
                       tiles=tuple(TPU_TILES["fused_matmul"].items()))
    from repro_torch.core.versaq import Epilogue, FusedFFN, apply_ffn, apply_linear

    site = dataclasses.replace(site, epilogue=Epilogue())
    with pytest.raises(ValueError, match="fused_matmul: cannot launch"):
        apply_linear(site, x)
    apply_linear(dataclasses.replace(site, tiles=tuple(fz.MATMUL_TILES.items())), x)
    down = QuantLinear(qw=quantize_weight(torch.randn((128, 64), generator=g), 4),
                       use_kernel=True, rotate_input=True, tiles=(("bm", 128),))
    f = FusedFFN(w_up=dataclasses.replace(site, epilogue=None, tiles=None), w_down=down)
    with pytest.raises(ValueError, match="fused_ffn: cannot launch"):
        apply_ffn(f, x)


# ---------------------------------------------------------------------------
# tuner and tuning DB
# ---------------------------------------------------------------------------


def test_tuning_db_cache_hits(tmp_path):
    cfg = get_config("vggt-1b-smoke")
    plan = PrecisionPlan(**PLANS["split"])
    db = str(tmp_path / "tune.json")
    t1 = Autotuner(db=TuningDB(db), budget=3, device="cpu")
    s1 = compile_schedule(cfg, plan, tuner=t1)
    assert t1.timing_runs == len(t1.db.entries) > 0 and t1.db.misses > 0
    assert os.path.exists(db) and s1.backend == "cpu"
    blob = json.loads(pathlib.Path(db).read_text())
    assert blob["version"] == ttuner.DB_VERSION and all(k.endswith("|cpu") for k in blob["entries"])
    t2 = Autotuner(db=TuningDB(db), budget=3, device="cpu")
    s2 = compile_schedule(cfg, plan, tuner=t2)
    assert t2.timing_runs == 0 and t2.db.misses == 0 and t2.db.hits > 0
    assert s2.hash == s1.hash
    # tuned tiles are the seed (launch) tiles: one candidate per kernel
    assert _strip(s1.canonical()) == _strip(compile_schedule(cfg, plan).canonical())
    assert [s.tiles for s in s1.sites] == [s.tiles for s in compile_schedule(cfg, plan).sites]


def test_cpu_costs_are_the_wrappers_bytes():
    t = Autotuner(db=TuningDB(), device="cpu")
    t.tune_matmul(256, 512, w_bits=4, a_bits=8, packed=True, fused=False)
    key = ttuner.matmul_key(256, 512, w_bits=4, a_bits=8, packed=True, fused=False, backend="cpu")
    assert t.db.entries[key]["cost"] == qm.function_bytes(ttuner.TUNE_M, 256, 512, packed=True)
    t.tune_attention(32)
    assert t.db.entries[ttuner.attention_key(32, backend="cpu")]["cost"] == \
        tsa.function_bytes(4, 4, ttuner.TUNE_LQ, ttuner.TUNE_LK, 32)


def test_tuner_injectable_measure():
    calls = []

    def measure(kind, tiles):
        calls.append((kind, dict(tiles)))
        return 1.0

    t = Autotuner(db=TuningDB(), budget=64, measure=measure)
    assert t.backend == "cuda"
    assert t.tune_matmul(512, 512, w_bits=4, a_bits=8, packed=True, fused=False) == qm.LAUNCH_TILES
    assert t.tune_matmul(512, 1536, w_bits=4, a_bits=8, packed=True, fused=True,
                         norm="ln") == fz.MATMUL_TILES
    assert t.tune_ffn(512, 2048, 512, w_bits_up=4, w_bits_down=4, a_bits_in=4,
                      a_bits_mid=8, norm="ln") == fz.FFN_TILES
    assert t.tune_attention(64) == tsa.LAUNCH_TILES
    assert [k for k, _ in calls] == ["quant_matmul", "fused_matmul", "fused_ffn", "two_stage_mha"]
    n = len(calls)
    t.tune_matmul(512, 512, w_bits=4, a_bits=8, packed=True, fused=False)
    assert len(calls) == n and t.timing_runs == n


def test_tuner_refuses_tiles_the_kernel_cannot_launch(tmp_path):
    db = TuningDB()
    key = ttuner.matmul_key(128, 128, w_bits=4, a_bits=8, packed=True, fused=False, backend="cpu")
    db.put(key, {"tiles": TPU_TILES["quant_matmul"], "cost": 1.0, "candidates": 1})
    t = Autotuner(db=db, device="cpu")
    with pytest.raises(ValueError, match="quant_matmul: cannot launch"):
        t.tune_matmul(128, 128, w_bits=4, a_bits=8, packed=True, fused=False)
    with pytest.raises(ValueError, match="expected one of"):
        Autotuner(db=TuningDB(), device="meta")
    with pytest.raises(ValueError, match="backend 'tpu'"):
        compile_schedule(get_config("vggt-1b-smoke"), PrecisionPlan(), backend="tpu")


@pytest.mark.parametrize("prequant,requant", [(False, False), (True, False), (False, True)])
def test_fused_matmul_function_bytes_are_its_operands(prequant, requant):
    """The byte count a ``fused_matmul`` launch records (and the tuner's
    CPU cost) is each operand and result moved once."""
    from repro_torch.kernels.measure import fused_matmul_inputs

    g = torch.Generator().manual_seed(1)
    (x, wv, ws, _, bias, u), kw = fused_matmul_inputs(
        lambda *shape: torch.randn(shape, generator=g), 33, 128, 192)
    xs = None
    if prequant:
        from repro_torch.core.quantize import quantize_per_token

        q = quantize_per_token(x, 8)
        x, xs, u = q.values, q.scale, None
    out = fz.fused_matmul_plain(x, wv, ws, xs, bias, u, **dict(
        kw, requant_bits=8 if requant else None, norm_kind=None if prequant else "ln"))
    outs = out if requant else (out,)
    want = fz._nbytes(x, xs, u, wv, ws, bias, *outs) + 4 * 64 * 64
    assert fz.matmul_function_bytes(33, 128, 192, packed=True, prequant=prequant,
                                    norm_u=u is not None, bias=True, requant=requant,
                                    idct=True) == want


@pytest.mark.parametrize("gated,w_bits", [(False, 4), (True, 8)])
def test_fused_ffn_function_bytes_are_its_operands(gated, w_bits):
    from repro_torch.kernels.measure import ffn_inputs

    g = torch.Generator().manual_seed(2)
    args, kw = ffn_inputs(lambda *shape: torch.randn(shape, generator=g), 21, 128, 256,
                          w_bits=w_bits, gated=gated)
    out = fz.fused_ffn_plain(*args, **kw)
    x, wu, wus, wd, wds, wg, wgs, bg, bu, bd, u = args
    want = fz._nbytes(x, u, wg, wgs, bg, wu, wus, bu, wd, wds, bd, out) + 4 * 64 * 64
    assert fz.ffn_function_bytes(
        21, 128, 256, 128, packed_u=w_bits == 4, packed_d=w_bits == 4,
        packed_g=gated and w_bits == 4, gated=gated, norm_u=True, bias_g=False, bias_u=True,
        bias_d=True, idct=True) == want
