"""The port's serving robustness layer against the JAX package's on the same
scripts: fault-plan grammar and seeded injection, admission control and
shedding, the degradation ladder, priority packing, precision tiers in the
VGGT engine, the ``nan@scene`` quarantine, and the LM engine's continuous-
mode fault cases (``tests/serving/test_faults.py``): the decode and prefill
quarantines, the numeric retry tier, ``slot_alloc`` and no fault variants
without a plan."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import jax

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.launch.specs import ServeSpec as JServeSpec
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving import batching as jb
from repro.serving import faults as jf
from repro.serving.vggt_engine import VGGTEngine as JVGGTEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.launch.specs import ServeSpec
from repro_torch.serving import batching as tb
from repro_torch.serving import faults as tf
from repro_torch.serving.engine import Engine as LMEngine
from repro_torch.serving.vggt_engine import Bucket, VGGTEngine
from tests.test_torch_lm import flatten_jax
from tests.test_torch_vggt_engine import REL_L2, _fixture, _scenes
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TIERS = "quality=fp,balanced=w4a8,fast=w4a8:fused"

# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

PLANS = [
    "nan@scene:req=1",
    "inf@scene",
    "nan@decode.logits:req=1,step=3;latency@poll:times=2,seconds=0.01;seed=7",
    "inf@prefill.logits:req=0;latency@decode:seconds=0.02,times=4",
    "crash@poll:times=3,p=0.5;seed=7",
    "crash;slot_alloc:req=2,times=0",
    " latency@prefill:seconds=0.5 ; nan:p=0.25 ;seed=0",
    "NAN@scene:req=4",
]

BAD_PLANS = ["teleport", "nan:when=now", "nan@poll", "crash@decode", "crash:p=0",
             "seed=3", "", "latency@scene", "nan:req", "nan:p=1.5", "inf:req=x"]


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parse_format_matches(text):
    """The same canonical string, the same specs, and a round trip."""
    try:
        want = jf.FaultPlan.parse(text)
    except ValueError as e:  # the reference refuses it: so must the port
        with pytest.raises(ValueError) as got:
            tf.FaultPlan.parse(text)
        assert str(got.value) == str(e)
        return
    got = tf.FaultPlan.parse(text)
    assert got.format() == want.format()
    assert [dataclasses.astuple(s) for s in got.specs] == [dataclasses.astuple(s) for s in want.specs]
    assert got.seed == want.seed
    assert tf.FaultPlan.parse(got.format()) == got


@pytest.mark.parametrize("text", BAD_PLANS)
def test_fault_plan_errors_match(text):
    with pytest.raises(ValueError) as want:
        jf.FaultPlan.parse(text)
    with pytest.raises(ValueError) as got:
        tf.FaultPlan.parse(text)
    assert str(got.value) == str(want.value)


class _Req:
    def __init__(self, req_id):
        self.req_id = req_id


def _drive(mod, plan):
    """One fixed script of hook calls; returns what fired."""
    inj = mod.FaultInjector(plan)
    out = []
    for i in range(40):
        rid = f"r{i % 7}"
        inj.on_enqueue(_Req(rid))
        out.append(("act", inj.activation("scene", rid)))
        out.append(("act_step", inj.activation("decode.logits", rid, step=i % 5)))
        out.append(("alloc", inj.alloc_fails(rid)))
        try:
            inj.crash("poll")
            out.append(("crash", False))
        except mod.InjectedFault as e:
            out.append(("crash", str(e)))
    out.append(("sleep", inj.sleep("prefill"), inj.sleep("poll")))
    return [repr(x) for x in out], inj.fired


@pytest.mark.parametrize("plan", [
    "crash@poll:p=0.5,times=0;seed=11",
    "nan@scene:req=3;inf@decode.logits:step=2,times=3,p=0.7;slot_alloc:p=0.3,times=0;seed=5",
    "latency@prefill:seconds=0.001;latency@poll:seconds=0.002,times=2;nan@scene:times=0",
])
def test_seeded_injector_fires_same_sequence(plan):
    assert _drive(tf, plan) == _drive(jf, plan)


# ---------------------------------------------------------------------------
# admission control and the degradation ladder
# ---------------------------------------------------------------------------

# (priority, deadline_s, size) per arrival, at t = 0.1 * ordinal
ARRIVALS = [(0, None, 4), (5, 2.0, 2), (1, None, 8), (1, 0.5, 1), (9, None, 4), (0, 1.0, 2),
            (3, 3.0, 16), (5, None, 1), (2, 0.2, 2), (7, 1.5, 4), (0, None, 1), (4, None, 4)]


def _admit(mod, policy, max_pending, max_tokens):
    """Run ARRIVALS through one AdmissionController; returns the rejected
    and shed ordinals and the stats."""
    ctl = mod.AdmissionController(max_pending=max_pending, max_queued_tokens=max_tokens,
                                  policy=policy)
    stats = mod.SchedulerStats()
    queued, sizes, rejected, shed = [], {}, [], []
    for i, (prio, dl, size) in enumerate(ARRIVALS):
        req = mod.PendingRequest(req_id=f"a{i}", priority=prio, deadline_s=dl,
                                 t_enqueue=0.1 * i)
        sizes[req.req_id] = size
        try:
            victims = ctl.check(req, queued, lambda r: sizes[r.req_id], stats)
        except mod.QueueFull:
            rejected.append(i)
            continue
        for v in victims:
            queued.remove(v)
            shed.append(int(v.req_id[1:]))
        queued.append(req)
    return rejected, shed, [r.req_id for r in queued], (stats.rejected, stats.shed)


@pytest.mark.parametrize("policy", ["reject", "shed"])
@pytest.mark.parametrize("max_pending,max_tokens", [(3, None), (None, 12), (4, 20), (1, None)])
def test_admission_rejects_and_sheds_same_ordinals(policy, max_pending, max_tokens):
    got = _admit(tb, policy, max_pending, max_tokens)
    want = _admit(jb, policy, max_pending, max_tokens)
    assert got == want
    assert got[0] or got[1]  # the script overloads every bound


def test_admission_errors_match():
    for kw in (dict(policy="drop"), dict(max_pending=0)):
        with pytest.raises(ValueError) as want:
            jb.AdmissionController(**kw)
        with pytest.raises(ValueError) as got:
            tb.AdmissionController(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", [
    dict(queue_high=4, dwell_s=1.0, recover_s=2.0),
    dict(queue_high=3, latency_high_s=0.1, dwell_s=0.3, recover_s=0.5),
    dict(queue_high=2, queue_low=0, latency_high_s=0.2, latency_low_s=0.05, dwell_s=0.0,
         recover_s=0.0, max_level=1),
])
def test_degradation_ladder_same_levels(cfg):
    """The same (pending, latency) series at the same times steps both
    ladders through the same levels."""
    rng = np.random.default_rng(3)
    pending = np.concatenate([rng.integers(0, 12, 60), np.zeros(30, int), rng.integers(0, 6, 40)])
    lat = [None if rng.random() < 0.2 else float(rng.exponential(0.12)) for _ in pending]
    out = []
    for mod in (tb, jb):
        c = mod.DegradationController(mod.DegradeConfig(**cfg), n_tiers=3)
        levels = [c.observe(int(p), lt, now=0.25 * i) for i, (p, lt) in enumerate(zip(pending, lat))]
        out.append((levels, c.shifts_down, c.shifts_up, c.max_level))
    assert out[0] == out[1]
    assert len(set(out[0][0])) > 1  # the series moves the ladder


def _packed(mod):
    """Priority packing: the order a flushing group runs its requests, and
    ``remove``."""
    runs = []
    q = mod.MicroBatchQueue(lambda key, reqs: runs.append([r.req_id for r in reqs]),
                            max_batch=4, max_wait_s=3600.0)
    req = {name: mod.PendingRequest(req_id=name, priority=prio, t_enqueue=float(i))
           for i, (name, prio) in enumerate((("p0", 0), ("p1", 2), ("x", 9), ("p2", 0),
                                             ("p3", 5), ("p4", 1)))}
    for name in ("p0", "p1", "x"):
        q.add("g", req[name], 1)
    removed = (q.remove(req["x"]), q.remove(req["x"]), q.pending)
    for name in ("p2", "p3"):  # the 4th item fills the group: it runs
        q.add("g", req[name], 1)
    q.add("g", req["p4"], 1)
    q.flush()
    return runs, removed


def test_priority_packing_and_remove_match():
    assert _packed(tb) == _packed(jb)


# ---------------------------------------------------------------------------
# the VGGT engine: tiers, quarantine, admission, ladder
# ---------------------------------------------------------------------------


def _tiered_engines(**kw):
    jcfg, cfg, jp, tp = _fixture()
    jt = {n: s.materialize() for n, s in JServeSpec.parse_tiers(TIERS).items()}
    tt = {n: s.materialize() for n, s in ServeSpec.parse_tiers(TIERS).items()}
    common = dict(attn_impl="two_stage", batch_buckets=(2,), max_batch=2, **kw)
    return JVGGTEngine(jcfg, jp, tiers=jt, **common), VGGTEngine(cfg, tp, tiers=tt,
                                                                   device="cpu", **common)


def test_three_tiers_match_reference_engine():
    """Six requests round-robin over three tiers: each tier's outputs within
    the engine bound of the JAX engine's same tier; requests coalesce only
    within their tier (one forward per tier); a second, warm round adds no
    first uses."""
    jeng, teng = _tiered_engines()
    names = list(teng.tiers)
    assert names == ["quality", "balanced", "fast"]
    assert teng.tiers["quality"] is None and teng.tiers["fast"].fuse
    requests = [_scenes(1, seed=s) for s in range(6)]
    for rnd in range(2):
        jreqs = [jeng.enqueue(jnp.asarray(x), tier=names[i % 3]) for i, x in enumerate(requests)]
        treqs = [teng.enqueue(x, tier=names[i % 3]) for i, x in enumerate(requests)]
        jeng.flush()
        teng.flush()
        assert teng.stats.calls == jeng.stats.calls == 3 * (rnd + 1)
        assert teng.stats.compiles == 3  # first round only: warm traffic reuses
        for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
            assert tr.tier == names[i % 3]
            for k in ("pose", "points", "depth"):
                got, want = tr.result()[k].numpy(), np.asarray(jr.result()[k])
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel < REL_L2, (tr.tier, k, rel)
    assert set(teng.stats.buckets) == {Bucket(2, 2, 24, t) for t in names}
    assert {str(b) for b in teng.stats.buckets} == {str(b) for b in jeng.stats.buckets}
    assert teng.stats.summary()["buckets"].keys() == jeng.stats.summary()["buckets"].keys()
    assert "wqkv" in teng.tier_params("fast")["blocks"]["frame"]["attn"]
    assert teng.tier_params("quality") is teng._raw
    with pytest.raises(KeyError):
        teng.enqueue(requests[0], tier="nope")


def test_scene_nan_quarantines_only_target_as_reference():
    """``nan@scene:req=1``: the second request alone fails with
    NumericFault in both engines; the others are served and agree with the
    JAX engine's."""
    jeng, teng = _tiered_engines(faults="nan@scene:req=1")
    requests = [_scenes(1, seed=s) for s in range(3)]
    jreqs = [jeng.enqueue(jnp.asarray(x), tier="balanced") for x in requests]
    treqs = [teng.enqueue(x, tier="balanced") for x in requests]
    jeng.flush()
    teng.flush()
    outcomes = []
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        failed = [None if r._error is None else type(r._error).__name__ for r in reqs]
        outcomes.append((failed, eng.stats.scheduler.numeric_faults, eng._injector.fired))
    assert outcomes[0] == outcomes[1] == ([None, "NumericFault", None], 1, {"nan": 1})
    with pytest.raises(tb.NumericFault, match="quarantined"):
        treqs[1].result()
    for i in (0, 2):
        got, want = treqs[i].result()["points"].numpy(), np.asarray(jreqs[i].result()["points"])
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < REL_L2


def _admission_script(eng, conv, tiers):
    """Bounded admission with shedding, then the degradation ladder: what
    was rejected, shed, and at which tier each request was admitted."""
    out = []
    for i, prio in enumerate((1, 5, 0, 3, 9)):
        try:
            r = eng.enqueue(conv(_scenes(1, seed=i)), priority=prio)
            out.append((i, r.tier))
        except Exception as e:
            out.append((i, type(e).__name__))
    shed = [type(r._error).__name__ if r.ready else None for r in eng._pending_list()]
    s = eng.stats.scheduler
    out.append((shed, s.rejected, s.shed, s.degraded_admissions, eng.degradation_level))
    eng.abort()
    return out


def test_engine_admission_and_ladder_match_reference():
    """``max_pending=2`` with shedding and an eager ladder (queue_high=0,
    no dwell): both engines reject, shed and downshift the same requests."""
    kw = dict(max_wait_s=3600.0, max_pending=2, admission="shed",
              degrade=jb.DegradeConfig(queue_high=0, dwell_s=0.0, recover_s=3600.0))
    jeng, _ = _tiered_engines(**kw)
    kw["degrade"] = tb.DegradeConfig(queue_high=0, dwell_s=0.0, recover_s=3600.0)
    _, teng = _tiered_engines(**kw)
    got = _admission_script(teng, lambda x: x, teng.tiers)
    want = _admission_script(jeng, jnp.asarray, jeng.tiers)
    assert got == want
    assert got[-1][1] + got[-1][2] > 0 and got[-1][3] > 0


def test_queue_full_then_flush_serves_the_first():
    """``max_pending=1``, a long ``max_wait_s``: the second enqueue raises
    QueueFull; ``flush`` serves the first request."""
    _, teng = _tiered_engines(max_wait_s=3600.0, max_pending=1)
    first = teng.enqueue(_scenes(1, seed=0), tier="balanced")
    assert not first.ready
    with pytest.raises(tb.QueueFull, match="admission rejected"):
        teng.enqueue(_scenes(1, seed=1), tier="fast")
    assert teng.stats.scheduler.rejected == 1 and teng.pending == 1
    teng.flush()
    assert np.isfinite(first.result()["points"].numpy()).all()


# ---------------------------------------------------------------------------
# the LM engine's continuous mode under faults (tests/serving/test_faults.py)
# ---------------------------------------------------------------------------

LM_TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64)


@functools.lru_cache(maxsize=1)
def _lm_fixture():
    jcfg = j_get_config("qwen3-14b-smoke").with_(**LM_TINY)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config("qwen3-14b-smoke").with_(**LM_TINY), jp, params_from_numpy(flatten_jax(jp))


def _lm_engines(**kw):
    """The reference's engine and the port's, same weights and arguments;
    ``tiers`` names "fp" or "w4a8" per tier."""
    jcfg, cfg, jp, tp = _lm_fixture()
    names = kw.pop("tiers", None)
    jkw, tkw = dict(kw), dict(kw)
    if names is not None:
        jkw["tiers"] = {n: None if v == "fp" else jvq.W4A8 for n, v in names.items()}
        tkw["tiers"] = {n: None if v == "fp" else PrecisionPlan(default="w4a8", use_kernel=True)
                        for n, v in names.items()}
    return JEngine(jcfg, jp, **jkw), LMEngine(cfg, tp, device="cpu", **tkw)


def _lm_prompt(n, seed):
    return np.random.default_rng(seed).integers(0, LM_TINY["vocab_size"], (n,)).astype(np.int32)


def _same_outcome(jreq, treq):
    """Both delivered the same ids, or both failed with the same error class."""
    if jreq._error is not None:
        assert type(treq._error).__name__ == type(jreq._error).__name__
        return
    assert treq._error is None, treq._error
    np.testing.assert_array_equal(treq.result(), np.asarray(jreq.result()))


def test_lm_nan_mid_decode_quarantines_only_target_continuous():
    """A NaN injected into one request's decode logits mid-burst fails that
    request with NumericFault; the co-resident slots deliver bit-exact
    against a fault-free run, and the same on the reference."""
    prompts = [_lm_prompt(8, s) for s in (0, 1, 2)]
    _, clean = _lm_engines(max_len=32, max_wait_s=0.0, batch_buckets=(4,))
    want = [clean.enqueue(p, 6) for p in prompts]
    clean.flush()
    engs = _lm_engines(max_len=32, max_wait_s=0.0, batch_buckets=(4,),
                       faults="nan@decode.logits:req=1,step=2")
    got = []
    for eng in engs:
        reqs = [eng.enqueue(p, 6) for p in prompts]
        eng.poll()  # all three admitted into one slot wave
        eng.flush()
        got.append(reqs)
        assert eng.stats.scheduler.numeric_faults == 1
        assert eng.stats.scheduler.numeric_retries == 0
        assert eng.active == 0  # the quarantined request's slot was released
    with pytest.raises(tb.NumericFault, match="quarantined"):
        got[1][1].result()
    for i in (0, 2):
        np.testing.assert_array_equal(got[1][i].result(), want[i].result())
    for j, t in zip(*got):
        _same_outcome(j, t)


def test_lm_inf_at_prefill_quarantines_before_slot_install():
    for eng in _lm_engines(max_len=32, max_wait_s=0.0, batch_buckets=(4,),
                           faults="inf@prefill.logits:req=0"):
        bad = eng.enqueue(_lm_prompt(8, 3), 4)
        good = eng.enqueue(_lm_prompt(8, 4), 4)
        eng.flush()
        with pytest.raises(Exception, match="prefill") as ei:
            bad.result()
        assert type(ei.value).__name__ == "NumericFault"
        assert good.result().shape == (4,)
        assert eng.stats.scheduler.numeric_faults == 1
        assert eng.active == 0


def test_lm_numeric_fault_retries_once_at_higher_tier():
    """``numeric_retry_tier``: the faulted request re-queues once at the
    quality tier and delivers that tier's ids (bucket mode's, and the
    reference's)."""
    tiers = {"quality": "fp", "fast": "w4a8"}
    reqs = []
    for eng in _lm_engines(max_len=32, max_wait_s=0.0, tiers=tiers, default_tier="fast",
                           numeric_retry_tier="quality",
                           faults="nan@decode.logits:req=0,step=0,times=1"):
        req = eng.enqueue(_lm_prompt(8, 5), 4)
        eng.flush()
        assert req.tier == "quality" and req.retries == 1
        assert eng.stats.scheduler.numeric_faults == 1
        assert eng.stats.scheduler.numeric_retries == 1
        reqs.append(req)
    _same_outcome(*reqs)
    _, cfg, _, tp = _lm_fixture()
    ref = LMEngine(cfg, tp, max_len=32, mode="bucket", device="cpu",
                   tiers={"quality": None, "fast": PrecisionPlan(default="w4a8", use_kernel=True)},
                   default_tier="fast")
    np.testing.assert_array_equal(reqs[1].result(),
                                  ref.generate(_lm_prompt(8, 5)[None, :], 4, tier="quality")[0])
    with pytest.raises(ValueError, match="numeric_retry_tier"):
        LMEngine(cfg, tp, numeric_retry_tier="nope", device="cpu")


def test_lm_slot_alloc_fault_fails_only_target():
    got = []
    for eng in _lm_engines(max_len=32, max_wait_s=0.0, faults="slot_alloc:req=0"):
        doomed = eng.enqueue(_lm_prompt(8, 8), 4)
        good = eng.enqueue(_lm_prompt(8, 9), 4)
        eng.flush()
        with pytest.raises(Exception, match="slot allocation") as ei:
            doomed.result()
        assert type(ei.value).__name__ == "InjectedFault"
        assert good.result().shape == (4,)
        got.append(good)
    _same_outcome(*got)


def test_lm_faults_off_has_no_fault_variants():
    """With no plan armed the decode step never takes the fault-armed
    variant (no inject vector, no per-step host copy)."""
    _, eng = _lm_engines(max_len=32, max_wait_s=0.0)
    assert eng._injector is None
    req = eng.enqueue(_lm_prompt(8, 10), 4)
    eng.flush()
    assert req.result().shape == (4,)
    # first-use keys are (bucket, variant, schedule hash)
    slot = [v for _, v, _ in eng._seen if isinstance(v, tuple) and v[0] == "slot"]
    assert slot and all(v[2] is False for v in slot)
