"""The port's serving launcher: ``ServeSpec`` against the JAX package's
(parse, format, tier maps, errors, materialization), the launcher's helpers
against the reference's, and ``python -m repro_torch.launch.serve`` run in
a subprocess that cannot import JAX or the JAX package."""
import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from repro.launch import serve as jserve
from repro.launch.specs import ServeSpec as JServeSpec
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.launch import serve
from repro_torch.launch.specs import ServeSpec
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]

SPECS = ["fp", "bf16", " W4A8 ", "w4a8", "w4a16", "w8a8", "w4a4", "w4a8:fused", "W8A8:FUSED",
         "plan", "plan:fused", "schedule=out/lm.schedule.json", "SCHEDULE=Out/X.json"]
BAD_SPECS = ["", "w4", "w4a", "4a8", "w4a8:quant", "bf16:fused", "fp:fused", "nope",
             "schedule=", "plan:slow"]
TIER_MAPS = ["quality=fp,balanced=w4a8,fast=w4a8:fused", "quality=fp, balanced=w4a8, fast=plan:fused",
             "a=schedule=x.json,b=W4A16", None, ""]
BAD_TIER_MAPS = ["fast", "=w4a8", "fast=", "a=fp,a=w4a8", "a=w4"]


def _fields(spec):
    return dataclasses.astuple(spec)


@pytest.mark.parametrize("s", SPECS)
def test_serve_spec_parse_format_matches(s):
    got, want = ServeSpec.parse(s, "rtn"), JServeSpec.parse(s, "rtn")
    assert _fields(got) == _fields(want)
    assert got.format() == want.format() == str(got)
    assert ServeSpec.parse(got.format(), "rtn") == got


@pytest.mark.parametrize("s", BAD_SPECS)
def test_serve_spec_errors_match(s):
    with pytest.raises(ValueError) as want:
        JServeSpec.parse(s)
    with pytest.raises(ValueError) as got:
        ServeSpec.parse(s)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("s", TIER_MAPS)
def test_tier_maps_match(s):
    got, want = ServeSpec.parse_tiers(s), JServeSpec.parse_tiers(s)
    if want is None:
        assert got is None
        return
    assert list(got) == list(want)
    assert [_fields(v) for v in got.values()] == [_fields(v) for v in want.values()]
    assert ServeSpec.format_tiers(got) == JServeSpec.format_tiers(want)
    assert ServeSpec.parse_tiers(ServeSpec.format_tiers(got)) == got


@pytest.mark.parametrize("s", BAD_TIER_MAPS)
def test_tier_map_errors_match(s):
    with pytest.raises(ValueError) as want:
        JServeSpec.parse_tiers(s)
    with pytest.raises(ValueError) as got:
        ServeSpec.parse_tiers(s)
    assert str(got.value) == str(want.value)


SITES = ["frame.attn.wq", "global.ffn.w_down", "frame.ffn.w_up"]


@pytest.mark.parametrize("s", ["w4a8", "w8a8", "w4a16", "w4a4"])
@pytest.mark.parametrize("method", ["versaq", "rtn"])
def test_materialize_uniform_level_routes_the_kernels(s, method):
    """A uniform level is the reference's policy at every site, with the
    integer matmul on the kernel."""
    got, want = ServeSpec.parse(s, method).materialize(), JServeSpec.parse(s, method).materialize()
    assert isinstance(got, PrecisionPlan) and got.use_kernel and not got.fuse
    for site in SITES:
        pol = got.policy_for(site)
        assert (pol.w_bits, pol.a_bits, pol.method) == (want.w_bits, want.a_bits, want.method)


def test_materialize_fp_and_fused_match():
    assert ServeSpec.parse("fp").materialize() is JServeSpec.parse("fp").materialize() is None
    got, want = ServeSpec.parse("w4a8:fused").materialize(), JServeSpec.parse("w4a8:fused").materialize()
    for f in ("default", "overrides", "method", "use_kernel", "fuse", "name"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("s", ["plan", "plan:fused", "schedule=tests/goldens/schedule_vggt_smoke.json"])
def test_materialize_refuses_planner_and_schedules(s):
    """``--policy`` refuses the planner as the reference does (it needs
    named tiers and weights), and a schedule the JAX package compiled (its
    tiles are TPU tilings), saying how to recompile it."""
    with pytest.raises(ValueError) as got:
        serve._parse_policy(s, "versaq")
    if s.startswith("plan"):
        with pytest.raises(ValueError) as want:
            jserve._parse_policy(s, "versaq")
        assert str(got.value) == str(want.value)
    else:
        assert "recompile it with python -m repro_torch.launch.compile" in str(got.value)
        with pytest.raises(ValueError, match="'interpret'"):
            ServeSpec.parse(s).materialize()


def _args(**kw):
    base = dict(max_pending=None, max_queued_tokens=None, admission="reject", degrade=False,
                faults=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [{}, dict(max_pending=3), dict(max_queued_tokens=99, admission="shed"),
                                dict(degrade=True, faults="nan@scene:req=1")])
def test_launcher_helpers_match(kw):
    assert serve._robustness_kwargs(_args(**kw)) == jserve._robustness_kwargs(_args(**kw))
    tiers = {"quality": None, "balanced": 1, "fast": 2}
    for n in (0, 1, 5, 7):
        assert serve._tier_cycle(tiers, n) == jserve._tier_cycle(tiers, n)
        assert serve._tier_cycle(None, n) == jserve._tier_cycle(None, n)


# The launcher in a process where JAX and the JAX package cannot be
# imported (a None entry in sys.modules makes their import raise).
_NO_JAX = ("import runpy, sys; sys.modules.update(jax=None, jaxlib=None, repro=None); "
           "sys.argv = ['serve'] + sys.argv[1:]; "
           "runpy.run_module('repro_torch.launch.serve', run_name='__main__')")


def _launch(*argv, threads=None):
    """The launcher in a process where JAX cannot be imported; ``threads``
    caps its intra-op threads (``OMP_NUM_THREADS``)."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["PYTHONPATH"] = str(ROOT / "src")
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.run([sys.executable, "-c", _NO_JAX, *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)


def test_launcher_serves_on_the_cpu_without_jax():
    out = _launch("--device", "cpu", "--arch", "vggt-1b-smoke", "--tiers",
                  "quality=fp,balanced=w4a8,fast=w4a8:fused", "--requests", "3", "--frames", "2",
                  "--patches", "16", "--metrics-port", "0", "--faults", "latency@prefill:seconds=0")
    assert out.returncode == 0, out.stderr
    assert "served 3/3 requests" in out.stdout
    for tier in ("quality", "balanced", "fast"):
        assert f"{tier}:b2xs2xp16" in out.stdout  # one bucket per tier
    assert "telemetry: http://127.0.0.1:" in out.stdout


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="this machine has a card")
def test_launcher_without_a_card_fails_rather_than_using_the_cpu():
    out = _launch("--arch", "vggt-1b-smoke", "--tiers", "quality=fp", "--requests", "1",
                  "--frames", "2", "--patches", "16")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "served" not in out.stdout


def test_launcher_refuses_other_archs_and_unported_specs():
    """An unknown ``--mode`` and the unported archs are refused; ``--policy
    plan`` needs named tiers; a schedule the JAX package compiled must be
    recompiled; a missing schedule file is reported, not a traceback."""
    out = _launch("--device", "cpu", "--arch", "qwen3-14b-smoke", "--mode", "slots")
    assert out.returncode != 0 and "mode='slots'" in out.stderr
    out = _launch("--device", "cpu", "--arch", "internlm2-20b-x")
    assert out.returncode != 0 and "unknown arch 'internlm2-20b-x'" in out.stderr
    assert "internlm2-20b-smoke" in out.stderr  # the registry lists every config
    out = _launch("--device", "cpu", "--tiers", "fast=schedule=tests/goldens/schedule_vggt_smoke.json")
    assert out.returncode != 0 and "recompile it with" in out.stderr
    out = _launch("--device", "cpu", "--tiers", "fast=schedule=x.json")
    assert out.returncode != 0 and "serve: FileNotFoundError" in out.stderr
    out = _launch("--device", "cpu", "--policy", "plan", "--frames", "2", "--patches", "16")
    assert out.returncode != 0 and "only valid in --tiers" in out.stderr


def test_launcher_serves_a_planned_tier_without_jax():
    out = _launch("--device", "cpu", "--arch", "vggt-1b-smoke", "--tiers",
                  "planned=plan:fused,fast=w4a8:fused", "--attn-impl", "two_stage",
                  "--requests", "4", "--frames", "2", "--patches", "16", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "tier 'planned': planned mixed precision {'w4a4': " in out.stdout
    assert "served 4/4 requests" in out.stdout and "planned:b2xs2xp16" in out.stdout


def test_lm_launcher_serves_on_the_cpu_without_jax():
    """qwen3-14b-smoke through the LM engine behind ``AsyncServer``: two
    tiers, mixed-length prompts (8 and 6 tokens, both in the l8 bucket),
    every request served, the per-bucket table with both tiers' prefill and
    decode rows, and the scheduler the ``auto`` mode resolved to (the
    continuous one)."""
    out = _launch("--device", "cpu", "--arch", "qwen3-14b-smoke", "--tiers",
                  "quality=fp,balanced=w4a8", "--requests", "4", "--prompt-len", "8", "--gen",
                  "8", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests -> 32 tokens" in out.stdout
    assert "scheduler: continuous" in out.stdout and "decode tok/s" in out.stdout
    for tier in ("quality", "balanced"):
        assert f"{tier}:prefill:b" in out.stdout and f"{tier}:decode:b" in out.stdout


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="this machine has a card")
def test_lm_launcher_without_a_card_fails_rather_than_using_the_cpu():
    out = _launch("--arch", "qwen3-14b-smoke", "--tiers", "quality=fp,balanced=w4a8",
                  "--requests", "4", "--prompt-len", "8", "--gen", "8", "--batch", "2")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "served" not in out.stdout
