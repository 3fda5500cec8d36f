"""The port's continuous scheduler (``DecodeRunner``, ``StateDecodeRunner``,
``Scheduler``) on the CPU against the JAX package's: the cases of the
reference's ``tests/serving/test_scheduler.py`` run on both engines with the
same script (a request joining the running batch, slot reuse without a new
first use, priority, deadline eviction queued and mid-decode, mixed
arrivals, SLA tier selection, the recurrent state runner, abort mid-decode,
the stats schema), greedy ids equal token for token to the reference's
continuous engine and to the port's bucket mode, for fp and W4A8 on
``qwen3-14b-smoke`` and fp on ``rwkv6-1.6b-smoke``.  Besides: a NaN in an
inactive slot leaves the live rows bit-exact, a sampled request draws the
same ids however it is coalesced, and the on-device sampler's frequencies
follow the softmax.
"""
import functools
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.models import lm
from repro_torch.serving.batching import DeadlineExceeded
from repro_torch.serving.engine import (
    DecodeRunner, Engine, PrefillBucket, StateDecodeRunner, sample_rows,
)

from test_torch_lm import flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

QWEN, RWKV = "qwen3-14b-smoke", "rwkv6-1.6b-smoke"
POLICIES = {"fp": (None, None),
            "w4a8": (jvq.W4A8, PrecisionPlan(default="w4a8", use_kernel=True))}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_get_config(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0 if arch == QWEN else 1))
    return jcfg, get_config(arch), jp, params_from_numpy(flatten_jax(jp))


def _engines(arch, policy="fp", **kw):
    """The reference's continuous engine and the port's, on the same weights."""
    jcfg, cfg, jp, tp = _setup(arch)
    jpol, tpol = POLICIES[policy]
    return (JEngine(jcfg, jp, policy=jpol, **kw),
            Engine(cfg, tp, policy=tpol, device="cpu", **kw))


@functools.lru_cache(maxsize=None)
def _bucket(arch, policy, max_len):
    _, cfg, _, tp = _setup(arch)
    return Engine(cfg, tp, policy=POLICIES[policy][1], max_len=max_len, mode="bucket",
                  device="cpu")


def _prompts(arch, b, n, seed):
    return np.random.default_rng(seed).integers(
        0, get_config(arch).vocab_size, (b, n)).astype(np.int32)


def _same(jreq, treq, want=None):
    """Ids of a port request equal the reference's and, when given, the
    port's bucket mode's."""
    got = treq.result()
    np.testing.assert_array_equal(got, np.asarray(jreq.result()))
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", ["fp", "w4a8"])
def test_request_joins_running_batch(policy):
    """ACCEPTANCE: a request enqueued while another is mid-decode is
    admitted before that batch drains, and both results are token-exact
    against the reference's continuous engine and the bucket mode (the
    roll-install masking argument)."""
    engs = _engines(QWEN, policy, max_len=64, max_wait_s=0.0, decode_steps_per_poll=2)
    pa, pb = _prompts(QWEN, 1, 16, 0), _prompts(QWEN, 1, 8, 1)
    reqs = []
    for eng in engs:
        assert eng.continuous
        ra = eng.enqueue(pa[0], 12)
        assert eng.poll() == 1  # A admitted, one bounded burst
        assert not ra.ready and eng.active == 1
        rb = eng.enqueue(pb[0], 4)
        assert eng.poll() == 1  # B joined the RUNNING batch
        assert eng.stats.scheduler.admitted_mid_decode == 1
        assert not ra.ready  # admission preceded A's drain
        eng.flush()
        reqs.append((ra, rb))
    ref = _bucket(QWEN, policy, 64)
    _same(reqs[0][0], reqs[1][0], ref.generate(pa, 12)[0])
    _same(reqs[0][1], reqs[1][1], ref.generate(pb, 4)[0])


def test_slots_free_and_reuse_without_new_first_use():
    """Finished requests release their slots; the next wave reuses them
    warm (no new first use) and still matches the reference and bucket
    mode exactly."""
    jeng, eng = _engines(QWEN, max_len=64, max_wait_s=0.0, batch_buckets=(2,))
    ref = _bucket(QWEN, "fp", 64)
    p1 = _prompts(QWEN, 2, 8, 2)
    got = eng.generate(p1, 6)
    np.testing.assert_array_equal(got, np.asarray(jeng.generate(p1, 6)))
    np.testing.assert_array_equal(got, ref.generate(p1, 6))
    assert eng.active == 0  # both slots released
    first = eng.stats.compiles
    p2 = _prompts(QWEN, 2, 8, 3)
    got = eng.generate(p2, 6)
    np.testing.assert_array_equal(got, np.asarray(jeng.generate(p2, 6)))
    np.testing.assert_array_equal(got, ref.generate(p2, 6))
    assert eng.stats.compiles == first  # freed slots reused warm


def test_priority_orders_admission():
    for eng in _engines(QWEN, max_len=64, max_wait_s=0.0, batch_buckets=(1,), max_batch=8):
        lo = eng.enqueue(_prompts(QWEN, 1, 8, 4)[0], 4, priority=0)
        hi = eng.enqueue(_prompts(QWEN, 1, 8, 5)[0], 4, priority=5)
        eng.poll()  # one slot: high priority wins it
        assert hi.ready and not lo.ready
        eng.flush()
        assert lo.result().shape == (4,)


def test_deadline_eviction_queued():
    _, eng = _engines(QWEN, max_len=64, max_wait_s=3600.0)
    req = eng.enqueue(_prompts(QWEN, 1, 8, 6)[0], 4, deadline_s=0.01)
    time.sleep(0.03)
    eng.poll()
    assert req.ready
    with pytest.raises(DeadlineExceeded, match="deadline"):
        req.result()
    assert eng.stats.scheduler.deadline_evictions == 1


def test_deadline_eviction_mid_decode():
    _, eng = _engines(QWEN, max_len=128, max_wait_s=0.0, decode_steps_per_poll=1)
    doomed = eng.enqueue(_prompts(QWEN, 1, 8, 7)[0], 64, deadline_s=0.5)
    eng.poll()  # admitted, decoding
    assert eng.active == 1 and not doomed.ready
    time.sleep(0.6)
    eng.poll()  # expired mid-decode -> evicted
    with pytest.raises(DeadlineExceeded, match="mid-decode"):
        doomed.result()
    assert eng.active == 0  # its slot returned to the free list
    assert eng.stats.scheduler.deadline_evictions == 1


def test_zero_new_first_uses_mixed_arrivals():
    """ACCEPTANCE: warm continuous traffic — mixed prompt lengths and
    generation lengths arriving against a running batch — uses no new
    bucket variant, joins mid-decode, and every request's ids equal the
    reference engine's under the same script and bucket mode's."""
    engs = _engines(QWEN, max_len=64, max_wait_s=0.0, batch_buckets=(4,))
    ref = _bucket(QWEN, "fp", 64)
    prompts = [_prompts(QWEN, 1, 8 if i % 2 else 12, 10 + i) for i in range(6)]
    all_reqs = []
    for eng in engs:
        eng.generate(_prompts(QWEN, 1, 8, 8), 4)  # warm L=8 (unmasked prefill)
        eng.generate(_prompts(QWEN, 1, 12, 9), 4)  # warm L=16 (masked prefill)
        compiles = eng.stats.compiles
        reqs = [eng.enqueue(p[0], 3 + i % 3) for i, p in enumerate(prompts)]
        for _ in range(64):
            eng.poll()
            if all(r.ready for r in reqs):
                break
        assert all(r.ready for r in reqs)
        assert eng.stats.compiles == compiles
        assert eng.stats.scheduler.admitted_mid_decode > 0
        assert 0.0 < eng.stats.scheduler.slot_occupancy <= 1.0
        all_reqs.append(reqs)
    for i, (j, t) in enumerate(zip(*all_reqs)):
        _same(j, t, ref.generate(prompts[i], 3 + i % 3)[0])
    assert engs[1].stats.scheduler.summary() == engs[0].stats.scheduler.summary()


def test_auto_tier_selects_by_measured_latency():
    _, cfg, _, tp = _setup(QWEN)
    eng = Engine(cfg, tp, max_len=64, max_wait_s=3600.0, device="cpu",
                 tiers={"quality": None, "fast": POLICIES["w4a8"][1]})
    # no measured traffic yet: auto falls back to the default tier
    assert eng._resolve_tier("auto", deadline_s=1.0) == "quality"
    for tier, lat in (("quality", 0.5), ("fast", 0.001)):
        s = eng.stats.bucket(PrefillBucket(1, 8, tier))
        s.calls, s.items, s.total_s = 1, 1, lat
        s.latencies_s.append(lat)
    assert eng._resolve_tier("auto", 1.0) == "quality"  # fits: best quality
    assert eng._resolve_tier("auto", 0.01) == "fast"  # SLA forces the drop
    assert eng._resolve_tier("auto", 1e-6) == "fast"  # nothing fits: fastest
    req = eng.enqueue(_prompts(QWEN, 1, 8, 20)[0], 2, tier="auto", deadline_s=0.01)
    assert req.tier == "fast"
    assert eng.abort() == 1


def test_recurrent_state_runner_joins_running_batch():
    """Position-free recurrent stacks use the state-cache runner: any prompt
    length joins a running batch, ids exact against the reference and
    bucket mode."""
    engs = _engines(RWKV, max_len=64, max_wait_s=0.0, decode_steps_per_poll=2)
    pa, pb = _prompts(RWKV, 1, 11, 21), _prompts(RWKV, 1, 7, 22)  # exact-length buckets
    reqs = []
    for eng in engs:
        assert eng.continuous and not eng.pad_prompts
        ra = eng.enqueue(pa[0], 8)
        eng.poll()
        assert not ra.ready
        rb = eng.enqueue(pb[0], 4)  # shorter prompt joins mid-decode
        eng.poll()
        assert eng.stats.scheduler.admitted_mid_decode == 1
        eng.flush()
        reqs.append((ra, rb))
    assert isinstance(engs[1]._sched.runner("default"), StateDecodeRunner)
    ref = _bucket(RWKV, "fp", 64)
    _same(reqs[0][0], reqs[1][0], ref.generate(pa, 8)[0])
    _same(reqs[0][1], reqs[1][1], ref.generate(pb, 4)[0])


def test_abort_mid_decode_releases_slots_for_reuse():
    """abort() mid-decode: active requests fail, their slots return to the
    free list, and the next admission reuses them without a new first use."""
    # max_batch above the queued rows so Scheduler.add's group auto-flush
    # never drains synchronously: the requests must stay mid-decode
    _, eng = _engines(QWEN, max_len=64, max_wait_s=0.0, batch_buckets=(2,), max_batch=8)
    ra = eng.enqueue(_prompts(QWEN, 1, 8, 40)[0], 12)
    rb = eng.enqueue(_prompts(QWEN, 1, 8, 41)[0], 12)
    eng.poll()  # both admitted, mid-decode
    assert eng.active == 2 and not ra.ready
    queued = eng.enqueue(_prompts(QWEN, 1, 8, 42)[0], 4)
    assert eng.abort() == 3  # 2 active + 1 queued all failed
    assert eng.active == 0  # slots back on the free list
    for r in (ra, rb, queued):
        with pytest.raises(RuntimeError, match="micro-batch failed") as ei:
            r.result()
        assert "aborted" in str(ei.value.__cause__)
    compiles = eng.stats.compiles
    p2 = _prompts(QWEN, 2, 8, 43)
    np.testing.assert_array_equal(eng.generate(p2, 6), _bucket(QWEN, "fp", 64).generate(p2, 6))
    assert eng.stats.compiles == compiles  # freed slots reused warm


def test_summary_schema_includes_scheduler():
    jeng, eng = _engines(QWEN, max_len=64)
    for e in (jeng, eng):
        e.generate(_prompts(QWEN, 2, 8, 30), 3)
    s, js = eng.stats.summary(), jeng.stats.summary()
    assert s["kind"] == "lm" and s["unit"] == "seqs" and s["mode"] == "continuous"
    assert s["scheduler"] == js["scheduler"] and s["scheduler"]["admitted"] == 1
    assert s["totals"]["items"] >= 2
    assert all("compiles" in b for b in s["buckets"].values())
    assert {str(b) for b in eng.stats.buckets} == {str(b) for b in jeng.stats.buckets}


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------


def _poison(runner: DecodeRunner, slot: int) -> None:
    """NaN into every float cache tensor of one slot (KV scales, rwkv
    states)."""
    for e in runner.cache["blocks"].values():
        for name in ("k_scale", "v_scale", "tshift", "cshift", "wkv"):
            if hasattr(e, name):
                getattr(e, name)[:, slot] = float("nan")


@pytest.mark.parametrize("arch", [QWEN, RWKV])
def test_nan_in_inactive_slot_leaves_live_rows_bit_exact(arch, monkeypatch):
    """A slot with no request carries garbage by design (a fully masked
    softmax row; a state nobody reset).  Fill one with NaN mid-decode: the
    live row's logits stay bit-for-bit those of a clean run (nothing in the
    step reduces across rows), its ids too, and nothing is quarantined."""
    _, cfg, _, tp = _setup(arch)
    prompt = _prompts(arch, 1, 8, 50)[0]
    step = lm.decode_step
    runs = []
    for poison in (False, True):
        logged = []

        def spy(*a, **kw):
            logits, cache = step(*a, **kw)
            logged.append(logits[:, 0].clone())
            return logits, cache

        monkeypatch.setattr(lm, "decode_step", spy)
        eng = Engine(cfg, tp, max_len=32, max_wait_s=0.0, batch_buckets=(2,),
                     decode_steps_per_poll=2, device="cpu")
        req = eng.enqueue(prompt, 8)
        eng.poll()
        runner = eng._sched.runner("default")
        assert runner.width == 2 and runner.slot_req[1] is None
        if poison:
            _poison(runner, 1)
        eng.flush()
        runs.append((req.result(), logged))
    (clean, clean_lg), (got, lg) = runs
    np.testing.assert_array_equal(got, clean)
    assert len(lg) == len(clean_lg) == 7
    for a, b in zip(lg, clean_lg):
        assert torch.equal(a[0], b[0])
    assert not torch.isfinite(lg[-1][1]).all()  # the poison reached the inactive row
    assert eng.stats.scheduler.numeric_faults == 0


@pytest.mark.parametrize("arch", [QWEN, RWKV])
def test_sampling_reproducible_under_any_coalescing(arch):
    """A sampled request gives the same ids served alone and served beside
    greedy and sampled neighbours, joining mid-decode in another slot; a
    different seed gives other ids."""
    _, cfg, _, tp = _setup(arch)
    prompt = _prompts(arch, 1, 8, 60)[0]
    kw = dict(max_len=64, max_wait_s=0.0, decode_steps_per_poll=2, device="cpu")

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    alone = Engine(cfg, tp, **kw)
    want = alone.enqueue(prompt, 10, generator=gen(5))
    alone.flush()
    eng = Engine(cfg, tp, max_batch=8, **kw)
    others = [eng.enqueue(_prompts(arch, 1, 8, 61)[0], 12),
              eng.enqueue(_prompts(arch, 2, 8, 62), 12, generator=gen(9))]
    eng.poll()
    req = eng.enqueue(prompt, 10, generator=gen(5))  # joins mid-decode, slot 3
    eng.poll()
    assert eng.stats.scheduler.admitted_mid_decode == 1
    eng.flush()
    np.testing.assert_array_equal(req.result(), want.result())
    assert all(o.ready for o in others)
    other_seed = Engine(cfg, tp, **kw).generate(prompt[None], 10, greedy=False,
                                                generator=gen(6))[0]
    assert not np.array_equal(other_seed, want.result())


def test_sampler_frequencies_follow_softmax():
    """Gumbel-max over the counter-based hash: across 40,000 seeds at one
    step, and across 40,000 steps of one seed, each token's frequency is
    within 4.5 standard errors of its softmax probability."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    p = torch.softmax(logits, 0).numpy()
    n = 40_000
    idx = torch.arange(n, dtype=torch.int64)
    for seeds, steps in ((idx, torch.zeros(n, dtype=torch.int64)),
                         (torch.full((n,), 7, dtype=torch.int64), idx)):
        tok = sample_rows(logits.expand(n, -1), seeds, steps)
        freq = np.bincount(tok.numpy(), minlength=len(p)) / n
        tol = 4.5 * np.sqrt(p * (1 - p) / n) + 1e-4
        assert (np.abs(freq - p) < tol).all(), (freq, p)
    # a row's draw depends only on its own (seed, step)
    lg = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    seeds, steps = torch.tensor([3, 1, 4, 1, 5]), torch.tensor([0, 2, 7, 1, 8])
    full = sample_rows(lg, seeds, steps)
    for i in range(5):
        assert sample_rows(lg[i:i + 1], seeds[i:i + 1], steps[i:i + 1])[0] == full[i]


def test_async_server_admits_submissions_mid_decode():
    """Behind ``AsyncServer`` the poll loop re-takes the engine lock burst
    after burst while slots decode; a request submitted then must still
    get the lock and join the running batch, not wait for the batch to
    drain.  One decode step a burst makes the bursts back to back."""
    from repro_torch.serving.server import AsyncServer

    _, cfg, _, tp = _setup(QWEN)
    eng = Engine(cfg, tp, max_len=128, batch_buckets=(1, 2), decode_steps_per_poll=1,
                 device="cpu")
    with AsyncServer(eng) as srv:
        first = srv.submit(_prompts(QWEN, 1, 8, seed=1)[0], 100)
        t_end = time.perf_counter() + 60
        while eng.active < 1 and time.perf_counter() < t_end:
            time.sleep(0.001)
        assert eng.active == 1
        second = srv.submit(_prompts(QWEN, 1, 8, seed=2)[0], 4)
        assert not first.ready  # submitted while the first request decodes
        srv.result(second, timeout=60)
        assert not first.ready  # the second joined and finished mid-decode
        srv.result(first, timeout=120)
    assert eng.stats.scheduler.admitted_mid_decode == 1
