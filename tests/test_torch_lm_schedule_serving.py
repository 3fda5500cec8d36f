"""Serving an LM from a compiled KernelSchedule in the port, on the CPU at
``qwen3-14b-smoke``, ``rwkv6-1.6b-smoke``, ``deepseek-moe-16b-smoke`` and
``phi3-mini-3.8b-smoke`` (the planner's configs that take token ids: the
engine serves no embedding inputs, as the reference's does not):
``Engine(schedule=path)`` token for token against ``Engine(policy=plan)``
and against the JAX package's ``Engine(schedule=...)`` on carried-across
weights, in bucket mode and through the continuous scheduler (a MoE model
against the reference's same mode only: capacity couples co-batched rows);
the schedule hash in every first-use key; the refusals; ``ServeSpec``'s
``plan`` level on an LM; and ``launch.compile`` then ``launch.serve
--schedule`` (and a ``plan:fused`` tier) in processes where JAX cannot be
imported."""
import pathlib

import numpy as np
import pytest

from repro.core.precision import PrecisionPlan as JPlan
from repro.core.precision import compile_schedule as j_compile
from repro.launch import roofline_util as jroof
from repro.launch.specs import ServeSpec as JServeSpec
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.core.precision import KernelSchedule, PrecisionPlan, compile_schedule
from repro_torch.core.precision import planner as tpl
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.launch import compile as tcompile
from repro_torch.launch.specs import ServeSpec
from repro_torch.serving.engine import Engine
from test_torch_lm_planner import ARCHS, _setup
from test_torch_schedule_serving import _no_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = str(ROOT / "tests" / "goldens" / "schedule_qwen3_smoke.json")
FUSED = dict(default="w4a8", use_kernel=True, fuse=True, name="w4a8")
N_STEPS = 8
SERVED = [a for a in ARCHS if not get_config(a).embed_inputs]
KW = {"bucket": dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0),
      "auto": dict(max_len=64, max_batch=4, batch_buckets=(1, 2, 4), max_wait_s=0.0,
                   decode_steps_per_poll=4)}


def _serve(eng, mode, vocab):
    """Bucket mode: 4 requests, then drain.  Continuous: two requests, two
    joining after one burst, then drain.  The same script on either side."""
    prompts = mixed_len_prompts(vocab, 4, 12)  # 12 and 9 tokens
    if mode == "bucket":
        reqs = [eng.enqueue(p, N_STEPS) for p in prompts]
    else:
        reqs = [eng.enqueue(p, N_STEPS) for p in prompts[:2]]
        eng.poll()
        reqs += [eng.enqueue(p, N_STEPS) for p in prompts[2:]]
    eng.flush()
    return [np.asarray(r.result()) for r in reqs]


@pytest.mark.parametrize("mode", ["bucket", "auto"])
@pytest.mark.parametrize("arch", SERVED)
def test_engine_schedule_matches_plan_and_reference_engine(tmp_path, arch, mode):
    jcfg, cfg, jp, tp = _setup(arch)
    path, jpath = str(tmp_path / "s.json"), str(tmp_path / "j.json")
    compile_schedule(cfg, PrecisionPlan(**FUSED), backend="cpu").save(path)
    j_compile(jcfg, JPlan(**FUSED)).save(jpath)
    eng = Engine(cfg, tp, schedule=path, mode=mode, device="cpu", **KW[mode])
    got = _serve(eng, mode, cfg.vocab_size)
    assert eng.stats.mode.startswith("continuous" if mode == "auto" else "bucket")
    want = _serve(Engine(cfg, tp, policy=PrecisionPlan(**FUSED), mode=mode, device="cpu",
                         **KW[mode]), mode, cfg.vocab_size)
    ref = _serve(JEngine(jcfg, jp, schedule=jpath, mode=mode, **KW[mode]), mode,
                 cfg.vocab_size)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        assert g.dtype == np.int32 and g.shape == (N_STEPS,)
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} vs the plan")
        np.testing.assert_array_equal(g, r, err_msg=f"request {i} vs the reference")
    # the schedule's hash keys every bucket and slot first use
    assert eng._seen and all(key[-1] == eng.schedule.hash for key in eng._seen)


def test_reference_compiled_lm_schedule_is_refused():
    _, cfg, _, tp = _setup("qwen3-14b-smoke")
    with pytest.raises(ValueError, match="recompile it with python -m repro_torch.launch.compile"):
        Engine(cfg, tp, schedule=GOLDEN, device="cpu")


def test_serve_spec_plan_materializes_on_an_lm(monkeypatch):
    """``plan[:fused]`` runs the planner on the LM (the reference's plan
    under its constants, stamped for the kernels)."""
    monkeypatch.setattr(tpl, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tpl, "HBM_BW", jroof.HBM_BW)
    jcfg, cfg, jp, tp = _setup("deepseek-moe-16b-smoke")
    for s in ("plan", "plan:fused"):
        got = ServeSpec.parse(s).materialize(cfg, tp, name="planned")
        want = JServeSpec.parse(s).materialize(jcfg, jp, name="planned")
        assert (got.default, got.overrides, got.fuse, got.name) == \
            (want.default, want.overrides, want.fuse, want.name)
        assert got.use_kernel


@pytest.mark.parametrize("arch,spec", [("qwen3-14b-smoke", "plan:fused"),
                                       ("rwkv6-1.6b-smoke", "w4a8"),
                                       ("deepseek-moe-16b-smoke", "w4a8:fused")])
def test_compile_and_serve_an_lm_schedule_without_jax(tmp_path, arch, spec):
    """The launcher's schedule is the in-process compile of the same plan
    (``plan`` on the seed-0 weights), and its printed counts say so."""
    sched, db = str(tmp_path / "lm.schedule.json"), str(tmp_path / "tune.json")
    args = ("--device", "cpu", "--arch", arch, "--spec", spec, "--tune", "--db", db)
    out = _no_jax("compile", *args, "--out", sched)
    assert out.returncode == 0, out.stderr
    assert "timing runs" in out.stdout and f"compiled {arch} x {spec}" in out.stdout
    cfg = get_config(arch)
    want = compile_schedule(cfg, tcompile.build_plan(ServeSpec.parse(spec), cfg, device="cpu"),
                            backend="cpu")
    assert KernelSchedule.load(sched).hash == want.hash
    assert f"sites={len(want.sites)} groups={len(want.groups)}" in out.stdout
    again = _no_jax("compile", *args, "--check", sched)
    assert again.returncode == 0, again.stderr
    assert "autotune: 0 timing runs" in again.stdout and "schedule matches golden" in again.stdout
    out = _no_jax("serve", "--device", "cpu", "--arch", arch, "--schedule", sched,
                  "--requests", "4", "--prompt-len", "8", "--gen", "6", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests -> 24 tokens" in out.stdout
    assert "scheduler: continuous" in out.stdout


def test_launcher_serves_a_planned_lm_tier_without_jax():
    out = _no_jax("serve", "--device", "cpu", "--arch", "qwen3-14b-smoke", "--tiers",
                  "quality=fp,planned=plan:fused", "--requests", "4", "--prompt-len", "8",
                  "--gen", "6", "--batch", "2", "--mode", "bucket")
    assert out.returncode == 0, out.stderr
    assert "tier 'planned': planned mixed precision" in out.stdout
    assert "served 4/4 requests" in out.stdout and "planned:prefill:b" in out.stdout
    out = _no_jax("serve", "--device", "cpu", "--arch", "qwen3-14b-smoke", "--schedule", GOLDEN,
                  "--requests", "1", "--prompt-len", "8", "--gen", "2")
    assert out.returncode != 0 and "recompile it with" in out.stderr
