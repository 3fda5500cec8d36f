"""Serving from a compiled KernelSchedule in the port, on the CPU at
``vggt-1b-smoke``: ``VGGTEngine(schedule=)`` (path or object) against the
plan it was compiled from and against the JAX package's engine; the
schedule hash in the bucket keys and its attention tiles on the config;
the refusals (``schedule=`` with ``policy=``/``tiers=``, a schedule the JAX
package compiled); ``ServeSpec``'s ``plan`` and ``schedule=`` levels; the
launches a schedule predicts, counted through recording wrappers; and
``launch.compile`` (``--check``, ``--tune``) and ``launch.serve
--schedule`` in processes where JAX cannot be imported."""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.precision import PrecisionPlan as JPlan
from repro.core.precision import compile_schedule as j_compile
from repro.launch import roofline_util as jroof
from repro.launch.specs import ServeSpec as JServeSpec
from repro.models import vggt as jvggt
from repro.serving.vggt_engine import VGGTEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import KernelSchedule, PrecisionPlan, compile_schedule
from repro_torch.core.precision import planner as tpl
from repro_torch.kernels import fused as fz
from repro_torch.kernels import probe
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import two_stage_attention as tsa
from repro_torch.launch import compile as tcompile
from repro_torch.launch.specs import ServeSpec
from repro_torch.serving import batching
from repro_torch.serving.vggt_engine import VGGTEngine
from test_torch_vggt import flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = str(ROOT / "tests" / "goldens" / "schedule_vggt_smoke.json")
FUSED = dict(default="w4a8", use_kernel=True, fuse=True, name="w4a8")
MIXED = dict(default="w4a8", use_kernel=True, fuse=True, name="mixed",
             overrides=(("frame.attn.wk", "w4a4"), ("global.ffn.w_down", "w8a8"),
                        ("global.attn.wo", "bf16")))
LS = 0.2  # LayerScale large enough that every block moves the outputs
# Engine outputs against the reference engine's on the same schedule, same
# weights and scenes (the kernels' plain versions vs Pallas in interpret
# mode; summation order only, as tests/test_torch_vggt_engine.py holds).
REL_L2 = 1e-3


@functools.lru_cache(maxsize=1)
def _setup():
    jcfg = j_get_config("vggt-1b-smoke").with_(layerscale_init=LS)
    cfg = get_config("vggt-1b-smoke").with_(layerscale_init=LS)
    jp = jvggt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(flatten_jax(jp))


def _scenes(b=2, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 2, 16, 128)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_engine_serves_the_schedule_as_the_plan(tmp_path):
    """Outputs through ``schedule=`` (a path) equal those of the plan it was
    compiled from; the hash is in every bucket key, the attention tiles on
    the engine's config."""
    _, cfg, _, tp = _setup()
    plan = PrecisionPlan(**MIXED)
    path = str(tmp_path / "s.json")
    compile_schedule(cfg, plan).save(path)
    eng = VGGTEngine(cfg, tp, schedule=path, attn_impl="two_stage", device="cpu")
    ref = VGGTEngine(cfg, tp, policy=plan, attn_impl="two_stage", device="cpu")
    x = _scenes()
    got, want = eng.infer(x), ref.infer(x)
    for k in ("pose", "points", "depth", "conf"):
        assert torch.equal(got[k], want[k]), k
    assert eng.schedule.hash == KernelSchedule.load(path).hash
    assert eng.cfg.attn_tiles == tuple(sorted(tsa.LAUNCH_TILES.items()))
    assert eng._seen and all(key[2] == eng.schedule.hash for key in eng._seen)
    eng.infer(x)
    assert eng.stats.compiles == 1  # warm traffic: no new bucket


def test_engine_schedule_matches_the_reference_engine():
    """The same fused mixed plan, compiled by each package and served by
    each engine on carried-across weights.  Its levels are A8 and bf16: an
    A4 site turns the ~1e-7 summation-order differences between the two
    frameworks into whole A4 steps now and then, which two AA pairs at
    LayerScale 0.2 carry to ~1e-2 (1.3e-2 on the pose with ``MIXED``)."""
    jcfg, cfg, jp, tp = _setup()
    plan = dict(MIXED, overrides=(("frame.attn.wk", "w8a8"),) + MIXED["overrides"][1:])
    jsched = j_compile(jcfg.with_(attn_impl="two_stage"), JPlan(**plan))
    sched = compile_schedule(cfg.with_(attn_impl="two_stage"), PrecisionPlan(**plan))
    assert [s.fallback for s in sched.sites] == [s.fallback for s in jsched.sites]
    assert any(s.fallback for s in sched.sites)
    x = _scenes(1, seed=1)
    want = JEngine(jcfg, jp, schedule=jsched, attn_impl="two_stage").infer(x)
    got = VGGTEngine(cfg, tp, schedule=sched, attn_impl="two_stage", device="cpu").infer(x)
    for k in ("pose", "points", "depth"):
        assert _rel(got[k], want[k]) < REL_L2, k


def test_schedule_conflicts_with_policy_and_tiers():
    _, cfg, _, tp = _setup()
    sched = compile_schedule(cfg, PrecisionPlan(**FUSED))
    with pytest.raises(ValueError, match="schedule"):
        VGGTEngine(cfg, tp, schedule=sched, policy=PrecisionPlan(), device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        VGGTEngine(cfg, tp, schedule=sched, tiers={"a": None}, device="cpu")
    with pytest.raises(TypeError, match="schedule= expects"):
        batching.load_schedule(PrecisionPlan())


def test_a_reference_compiled_schedule_is_refused():
    _, cfg, _, tp = _setup()
    for load in (lambda: VGGTEngine(cfg, tp, schedule=GOLDEN, device="cpu"),
                 lambda: ServeSpec.parse(f"schedule={GOLDEN}").materialize()):
        with pytest.raises(ValueError, match="recompile it with python -m repro_torch.launch.compile"):
            load()


def test_serve_spec_plan_and_schedule_materialize(monkeypatch, tmp_path):
    """``plan[:fused]`` runs the planner (the reference's plan under its
    constants, stamped for the kernels); ``schedule=<path>`` loads."""
    jcfg, cfg, jp, tp = _setup()
    monkeypatch.setattr(tpl, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tpl, "HBM_BW", jroof.HBM_BW)
    for s in ("plan", "plan:fused"):
        got = ServeSpec.parse(s).materialize(cfg, tp, name="planned")
        want = JServeSpec.parse(s).materialize(jcfg, jp, name="planned")
        assert (got.default, got.overrides, got.fuse, got.name) == \
            (want.default, want.overrides, want.fuse, want.name)
        assert got.use_kernel
    with pytest.raises(ValueError, match="needs a model to plan"):
        ServeSpec.parse("plan").materialize()
    sched = compile_schedule(cfg, PrecisionPlan(**FUSED), backend="cpu")
    path = str(tmp_path / "s.json")
    sched.save(path)
    loaded = ServeSpec.parse(f"schedule={path}").materialize()
    assert isinstance(loaded, KernelSchedule) and loaded.hash == sched.hash


def _recording(monkeypatch):
    """Kernel wrappers that record their launch and run the plain version:
    the launch accounting of the card, on the CPU."""
    for mod, name in ((qm, "quant_matmul"), (qm, "quant_matmul_batched"),
                      (tsa, "two_stage_attention"), (fz, "fused_matmul"), (fz, "fused_ffn")):
        plain = getattr(mod, f"{name}_plain")

        def run(*a, _plain=plain, _name=name, **kw):
            probe.record(_name)
            return _plain(*a, **kw)

        monkeypatch.setattr(mod, name, run)


@pytest.mark.parametrize("plan", [FUSED, MIXED, dict(default="w4a8", use_kernel=True),
                                  dict(MIXED, use_kernel=False, fuse=False)],
                         ids=["fused", "mixed", "unfused", "emulated"])
def test_launches_per_forward_counts_what_the_forward_launches(monkeypatch, plan):
    _, cfg, _, tp = _setup()
    sched = compile_schedule(cfg, PrecisionPlan(**plan))
    _recording(monkeypatch)
    eng = VGGTEngine(cfg, tp, schedule=sched, attn_impl="two_stage", device="cpu")
    eng.params  # quantize outside the counted window
    with probe.tracking() as log:
        eng.infer(_scenes(1))
    assert log.by_name() == sched.launches_per_forward(two_stage_attention=True)
    flash = VGGTEngine(cfg, tp, schedule=sched, attn_impl="flash", device="cpu")
    flash.params
    with probe.tracking() as log:
        flash.infer(_scenes(1))
    assert log.by_name() == sched.launches_per_forward(two_stage_attention=False)


def test_compile_check_passes_and_exits_1_on_drift(tmp_path, capsys):
    path = str(tmp_path / "s.json")
    args = ["--device", "cpu", "--arch", "vggt-1b-smoke", "--spec", "w4a8:fused"]
    assert tcompile.main(args + ["--out", path]) == 0
    assert tcompile.main(args + ["--check", path]) == 0
    assert "schedule matches golden" in capsys.readouterr().out
    blob = json.loads(pathlib.Path(path).read_text())
    blob["sites"][0]["tiles"] = {"bm_target": 256}
    pathlib.Path(path).write_text(json.dumps(blob))
    assert tcompile.main(args + ["--check", path]) == 1
    err = capsys.readouterr().err
    assert "SCHEDULE DRIFT" in err and "bm_target" in err
    assert tcompile.main(args[:4] + ["--spec", "schedule=x.json"]) == 1
    assert "already compiled" in capsys.readouterr().err


def test_compile_builds_the_plan_as_the_reference(monkeypatch):
    jcfg, cfg, _, _ = _setup()
    from repro.launch.compile import build_plan as j_build_plan

    for s in ("fp", "w4a8", "w4a8:fused", "w8a8"):
        got = tcompile.build_plan(ServeSpec.parse(s), cfg, device="cpu")
        want = j_build_plan(JServeSpec.parse(s), jcfg)
        assert (got.default, got.use_kernel, got.fuse, got.name) == \
            (want.default, want.use_kernel, want.fuse, want.name), s


# The launchers in processes where JAX and the JAX package cannot be
# imported (a None entry in sys.modules makes their import raise).
def _no_jax(module, *argv):
    code = ("import runpy, sys; sys.modules.update(jax=None, jaxlib=None, repro=None); "
            f"sys.argv = ['{module}'] + sys.argv[1:]; "
            f"runpy.run_module('repro_torch.launch.{module}', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)


def test_compile_and_serve_a_planned_schedule_without_jax(tmp_path):
    sched, db = str(tmp_path / "vggt.schedule.json"), str(tmp_path / "tune.json")
    args = ("--device", "cpu", "--arch", "vggt-1b-smoke", "--spec", "plan:fused", "--tune",
            "--db", db)
    out = _no_jax("compile", *args, "--out", sched)
    assert out.returncode == 0, out.stderr
    assert "planned mixed precision" in out.stdout and "timing runs" in out.stdout
    again = _no_jax("compile", *args, "--check", sched)
    assert again.returncode == 0, again.stderr
    assert "autotune: 0 timing runs" in again.stdout
    out = _no_jax("serve", "--device", "cpu", "--arch", "vggt-1b-smoke", "--schedule", sched,
                  "--attn-impl", "two_stage", "--requests", "3", "--frames", "2",
                  "--patches", "16", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "served 3/3 requests" in out.stdout
    out = _no_jax("serve", "--device", "cpu", "--arch", "vggt-1b-smoke", "--schedule", GOLDEN,
                  "--requests", "1", "--frames", "2", "--patches", "16")
    assert out.returncode != 0 and "recompile it with" in out.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a card")
def test_compile_without_a_card_fails_rather_than_using_the_cpu():
    out = _no_jax("compile", "--arch", "vggt-1b-smoke")
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "compiled" not in out.stdout
