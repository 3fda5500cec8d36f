"""The port's LM ``Engine`` on the CPU (``device="cpu"``): greedy ids
against the JAX package's ``Engine(mode="bucket")`` on ``mixed_len_prompts``
traffic in fp and W4A8 tiers, and the reference's own engine checks
(``tests/serving/test_lm_engine.py``) run on the port in both modes (the
default ``auto``, continuous for these configs, and bucket mode; only
bucket mode where a check is about it): padded buckets token-exact against the unpadded prefill +
decode, exact-length buckets for rwkv, first-use counts per bucket variant,
micro-batch split/merge, deadline flushes, overflow, sampling with an
explicit generator, token accounting; plus the numeric quarantine under an
injected fault, admission, the modes and the default device.
"""
import functools

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
from repro_torch.core.precision import compile_schedule
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.models import lm
from repro_torch.serving.batching import DeadlineExceeded, NumericFault, QueueFull
from repro_torch.serving.engine import DecodeBucket, Engine, PrefillBucket

from test_torch_lm import flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64)
MAX_LEN = 32
W4A8 = PrecisionPlan(default="w4a8", use_kernel=True)


@functools.lru_cache(maxsize=1)
def _fixture():
    cfg = get_config("qwen3-14b-smoke").with_(**TINY)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0))


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg = j_get_config("qwen3-14b-smoke")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config("qwen3-14b-smoke"), jp, params_from_numpy(flatten_jax(jp))


def _prompts(b, n, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, n)).astype(np.int32)


# the default mode (continuous for attention-only patterns) and bucket mode:
# each of the reference's engine checks below holds for both schedulers
MODES = ("auto", "bucket")


def _engine(**kw):
    cfg, params = _fixture()
    return Engine(cfg, params, max_len=kw.pop("max_len", MAX_LEN), device="cpu", **kw)


def _ref_generate(params, prompts, n_steps, cfg=None, max_len=MAX_LEN):
    """Unbatched, unpadded prefill + greedy decode loop on the port's lm."""
    cfg = cfg or _fixture()[0]
    toks = torch.as_tensor(prompts).long()
    cache = lm.init_cache(cfg, toks.shape[0], max_len)
    logits, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill")
    tok = torch.argmax(logits[:, -1], -1)
    out = [tok]
    for _ in range(n_steps - 1):
        logits, cache = lm.decode_step(cfg, params, tok, cache)
        tok = torch.argmax(logits[:, 0], -1)
        out.append(tok)
    return torch.stack(out, dim=1).numpy()


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------


def test_engine_matches_reference_engine_on_mixed_traffic():
    """One engine with a ``quality`` (fp) and a ``balanced`` (W4A8) tier on
    both sides, 8 requests of ``mixed_len_prompts`` (12 and 9 tokens, both
    in the l16 bucket, so masked groups serve) round-robin over the tiers,
    12 new tokens each: the same greedy ids for every request."""
    jcfg, cfg, jp, tp = _smoke()
    prompts = mixed_len_prompts(cfg.vocab_size, 8, 12)
    kw = dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0)
    jeng = JEngine(jcfg, jp, tiers={"quality": None, "balanced": jvq.W4A8}, mode="bucket", **kw)
    teng = Engine(cfg, tp, tiers={"quality": None, "balanced": W4A8}, mode="bucket",
                  device="cpu", **kw)
    tiers = ["quality", "balanced"]
    jreqs = [jeng.enqueue(p, 12, tier=tiers[i % 2]) for i, p in enumerate(prompts)]
    treqs = [teng.enqueue(p, 12, tier=tiers[i % 2]) for i, p in enumerate(prompts)]
    jeng.flush()
    teng.flush()
    for i, (j, t) in enumerate(zip(jreqs, treqs)):
        got = t.result()
        assert got.dtype == np.int32 and got.shape == (12,)
        np.testing.assert_array_equal(got, np.asarray(j.result()), err_msg=f"request {i}")
    assert {str(b) for b in teng.stats.buckets} == {str(b) for b in jeng.stats.buckets}
    for b, s in teng.stats.buckets.items():
        js = next(v for k, v in jeng.stats.buckets.items() if str(k) == str(b))
        assert (s.calls, s.items, s.tokens, s.compiles) == (js.calls, js.items, js.tokens,
                                                            js.compiles), b


def test_fused_tier_matches_reference_engine():
    """The fused W4A8 plan (``fused_matmul`` for Q/K/V and ``wo``,
    ``fused_ffn``) as a tier, against the reference's fused plan."""
    from repro.core.precision.plan import PrecisionPlan as JPlan

    jcfg, cfg, jp, tp = _smoke()
    prompts = np.stack(mixed_len_prompts(cfg.vocab_size, 3, 12)[::2])
    jeng = JEngine(jcfg, jp, policy=JPlan(default="w4a8", use_kernel=True, fuse=True),
                   mode="bucket", max_len=32)
    teng = Engine(cfg, tp, policy=PrecisionPlan(default="w4a8", use_kernel=True, fuse=True),
                  mode="bucket", max_len=32, device="cpu")
    np.testing.assert_array_equal(teng.generate(prompts, 10), np.asarray(jeng.generate(prompts, 10)))


# ---------------------------------------------------------------------------
# the reference's engine checks, on the port
# ---------------------------------------------------------------------------


def test_generate_padded_prompt_matches_unpadded_reference():
    """l=12 pads into the l16 bucket (masked); the ids equal the unpadded
    prefill + decode, in both modes."""
    prompts = _prompts(2, 12, seed=1)
    want = _ref_generate(_fixture()[1], prompts, 6)
    for mode in MODES:
        eng = _engine(batch_buckets=(2,), mode=mode)
        assert np.array_equal(eng.generate(prompts, 6), want), mode
        assert PrefillBucket(2, 16) in eng.stats.buckets, mode


def test_batch_padding_matches_unpadded_reference():
    prompts = _prompts(3, 16, seed=2)
    want = _ref_generate(_fixture()[1], prompts, 5)
    for mode in MODES:
        eng = _engine(batch_buckets=(4,), mode=mode)
        got = eng.generate(prompts, 5)
        assert got.shape == (3, 5)
        assert np.array_equal(got, want), mode
        assert eng.stats.bucket(PrefillBucket(4, 16)).padded_items == 1, mode


def test_quantized_engine_padded_matches_quantized_reference():
    prompts = _prompts(1, 10, seed=3)
    for mode in MODES:
        eng = _engine(policy=W4A8, batch_buckets=(1,), mode=mode)
        got = eng.generate(prompts, 5)
        assert np.array_equal(got, _ref_generate(eng.params, prompts, 5)), mode


def test_mixed_traffic_first_uses_bounded_per_bucket_variant():
    """Bucket mode, two prompt lengths x two batch sizes, repeated: at most
    one first use per (bucket, masked) variant, every request equal to its
    own unbatched forward, and repeat traffic counts no new first use (the
    continuous mode's variants: ``tests/test_torch_scheduler.py``)."""
    eng = _engine(batch_buckets=(2, 4), mode="bucket")
    params = _fixture()[1]

    def wave(seed):
        for i, (b, n) in enumerate([(2, 12), (4, 12), (2, 16), (4, 16)]):
            prompts = _prompts(b, n, seed=seed + i)
            assert np.array_equal(eng.generate(prompts, 4), _ref_generate(params, prompts, 4))

    wave(100)
    first = eng.stats.compiles
    for b in (PrefillBucket(2, 16), PrefillBucket(4, 16), DecodeBucket(2), DecodeBucket(4)):
        assert eng.stats.bucket(b).compiles == 2, b  # masked and unmasked
    assert first == 8
    wave(200)
    assert eng.stats.compiles == first


def test_microbatch_coalesce_split_roundtrip():
    params = _fixture()[1]
    singles = [_prompts(1, 10, seed=30 + i)[0] for i in range(3)]
    batch2 = _prompts(1, 12, seed=40)  # same l16 group; 3 + 1 == max_batch
    for mode in MODES:
        eng = _engine(batch_buckets=(4,), max_batch=4, mode=mode)
        reqs = [eng.enqueue(p, 4) for p in singles]
        assert not any(r.ready for r in reqs), mode
        r4 = eng.enqueue(batch2, 4)
        assert all(r.ready for r in reqs) and r4.ready, mode  # auto-flush on fill
        assert eng.stats.bucket(PrefillBucket(4, 16)).calls == 1, mode
        for i, (p, r) in enumerate(zip(singles, reqs)):
            assert np.array_equal(r.result(), _ref_generate(params, p[None, :], 4)[0]), (mode, i)
        assert np.array_equal(r4.result(), _ref_generate(params, batch2, 4)), mode


def test_poll_flushes_after_deadline():
    for mode in MODES:
        eng = _engine(max_batch=8, max_wait_s=0.0, mode=mode)
        req = eng.enqueue(_prompts(1, 8, seed=50)[0], 3)
        assert not req.ready, mode
        assert eng.poll() == 1, mode  # a group flushed (bucket), a request admitted (auto)
        assert req.ready, mode


def test_mixed_n_steps_coalesce():
    want_a = _ref_generate(_fixture()[1], _prompts(1, 8, seed=60), 6)[0, :3]
    for mode in MODES:
        eng = _engine(max_batch=8, mode=mode)
        a = eng.enqueue(_prompts(1, 8, seed=60)[0], 3)
        b = eng.enqueue(_prompts(1, 8, seed=61)[0], 6)
        eng.flush()
        assert a.result().shape == (3,) and b.result().shape == (6,), mode
        assert np.array_equal(a.result(), want_a), mode


def test_generate_rejects_cache_overflow():
    prompts = _prompts(1, 8, seed=70)
    for mode in MODES:
        eng = _engine(max_len=16, batch_buckets=(1,), mode=mode)
        assert eng.generate(prompts, 9).shape == (1, 9)  # 8 + 9 - 1 == 16 fits exactly
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            eng.generate(prompts, 10)
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            eng.enqueue(prompts[0], 10)
        with pytest.raises(ValueError, match="n_steps"):
            eng.generate(prompts, 0)
        # a prompt longer than max_len fails with its REAL length
        with pytest.raises(ValueError, match="length 20"):
            eng.enqueue(_prompts(1, 20, seed=71)[0], 1)


def test_sampling_requires_generator():
    """Sampling needs an explicit generator, and the same seed gives the
    same sample, in both modes; a per-request generator needs the
    continuous scheduler, which bucket mode refuses."""
    prompts = _prompts(1, 8, seed=80)
    for mode in MODES:
        eng = _engine(batch_buckets=(1,), mode=mode)
        with pytest.raises(ValueError, match="torch.Generator"):
            eng.generate(prompts, 4, greedy=False)
        out = eng.generate(prompts, 4, greedy=False, generator=torch.Generator().manual_seed(7))
        assert out.shape == (1, 4) and (out >= 0).all() and (out < TINY["vocab_size"]).all()
        again = eng.generate(prompts, 4, greedy=False,
                             generator=torch.Generator().manual_seed(7))
        assert np.array_equal(out, again), mode  # same seed, same sample
        if mode == "bucket":
            with pytest.raises(ValueError, match="continuous scheduler"):
                eng.enqueue(prompts[0], 4, generator=torch.Generator().manual_seed(7))
        else:
            req = eng.enqueue(prompts[0], 4, generator=torch.Generator().manual_seed(7))
            eng.flush()
            assert np.array_equal(req.result(), out[0])  # the same stream through enqueue


def test_first_token_is_sampled_not_greedy():
    prompts = _prompts(1, 8, seed=81)
    for mode in MODES:
        eng = _engine(batch_buckets=(1,), mode=mode)
        greedy_first = eng.generate(prompts, 1)[0, 0]
        sampled = [eng.generate(prompts, 1, greedy=False,
                                generator=torch.Generator().manual_seed(k))[0, 0]
                   for k in range(8)]
        assert any(t != greedy_first for t in sampled), (mode, sampled)


def test_decode_token_accounting():
    for mode in MODES:
        eng = _engine(batch_buckets=(4,), mode=mode)
        eng.generate(_prompts(4, 8, seed=90), 8)
        assert eng.stats.decode_tokens == 4 * 7, mode
        assert eng.stats.prefill_tokens == 4 * 8, mode
        assert eng.stats.bucket(DecodeBucket(4)).calls == 7, mode
        eng2 = _engine(batch_buckets=(4,), mode=mode)
        eng2.generate(_prompts(4, 8, seed=91), 1)
        assert eng2.stats.decode_tokens == 0 and eng2.stats.decode_s == 0.0, mode


# ---------------------------------------------------------------------------
# robustness, modes, device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site,stage", [("decode.logits:req=1,step=2", "decode"),
                                        ("prefill.logits:req=1", "prefill")])
def test_injected_nan_fails_only_its_request(site, stage):
    """``nan@<site>`` poisons request 1's logits; it alone fails with
    ``NumericFault`` and its co-batched neighbours deliver their own ids,
    in both modes."""
    params = _fixture()[1]
    prompts = [_prompts(1, 8, seed=100 + i)[0] for i in range(3)]
    for mode in MODES:
        eng = _engine(batch_buckets=(4,), max_batch=3, faults=f"nan@{site}", mode=mode)
        reqs = [eng.enqueue(p, 5) for p in prompts]
        assert all(r.ready for r in reqs), mode
        with pytest.raises(NumericFault, match=stage):
            reqs[1].result()
        for i in (0, 2):
            assert np.array_equal(reqs[i].result(),
                                  _ref_generate(params, prompts[i][None], 5)[0]), (mode, i)
        assert eng.stats.scheduler.numeric_faults == 1, mode


def test_admission_rejects_past_max_pending():
    for mode in MODES:
        eng = _engine(max_batch=4, max_pending=1, mode=mode)
        first = eng.enqueue(_prompts(1, 8, seed=1)[0], 2)
        with pytest.raises(QueueFull):
            eng.enqueue(_prompts(1, 8, seed=2)[0], 2)
        assert eng.stats.scheduler.rejected == 1 and not first.ready, mode
        eng.flush()
        assert first.result().shape == (2,), mode


def test_deadline_evicts_unserved_request():
    for mode in MODES:
        eng = _engine(max_batch=4, max_wait_s=60.0, mode=mode)
        req = eng.enqueue(_prompts(1, 8, seed=3)[0], 2, deadline_s=0.0)
        eng.poll()
        with pytest.raises(DeadlineExceeded):
            req.result()


def test_modes_and_schedule():
    """``auto`` serves the continuous scheduler for attention-only and
    position-free recurrent patterns and says so in the stats; for a
    pattern that mixes them it serves bucket mode and says why, and
    ``continuous`` raises there, as in the reference.  ``schedule=``
    serves a compiled schedule in place of a policy or tiers (token parity
    in ``tests/test_torch_lm_schedule_serving.py``); every layer kind
    constructs (a Mamba/attention hybrid in bucket mode, as jamba)."""
    eng = _engine()
    assert eng.mode == "continuous" and eng.continuous
    assert eng.stats.summary()["mode"] == "continuous"
    assert eng.stats.format().startswith("scheduler: continuous")
    assert _engine(mode="continuous").continuous
    assert _engine(mode="bucket").stats.mode == "bucket" and not _engine(mode="bucket").continuous
    cfg, params = _fixture()
    rwkv = get_config("rwkv6-1.6b-smoke")
    rparams = lm.init_params(rwkv, torch.Generator().manual_seed(0))
    for m in ("auto", "continuous"):
        reng = Engine(rwkv, rparams, max_len=MAX_LEN, mode=m, device="cpu")
        assert reng.continuous and not reng.pad_prompts and reng.stats.mode == "continuous"
    hybrid = cfg.with_(pattern=("attn", "rwkv"), rwkv_head_dim=16)
    hparams = lm.init_params(hybrid, torch.Generator().manual_seed(0))
    heng = Engine(hybrid, hparams, max_len=MAX_LEN, device="cpu")
    assert not heng.continuous and heng.stats.mode.startswith("bucket (mode='auto': pattern")
    with pytest.raises(ValueError, match="mode='continuous' needs"):
        Engine(hybrid, hparams, max_len=MAX_LEN, mode="continuous", device="cpu")
    sched = compile_schedule(cfg, W4A8)
    eng = _engine(schedule=sched)
    assert eng.schedule is sched and eng.policy is sched
    assert eng.cfg.attn_tiles == sched.attention_targets()
    for kw in (dict(policy=W4A8), dict(tiers={"w4a8": W4A8})):
        with pytest.raises(ValueError, match="either schedule= or policy=/tiers="):
            _engine(schedule=sched, **kw)
    with pytest.raises(ValueError, match="mode"):
        _engine(mode="slots")
    for kw in (dict(pattern=("attn", "mamba")), dict(mla=True), dict(embed_inputs=True)):
        if "mla" in kw:
            # ported: an MLA stack (deepseek-v2-lite-16b-smoke) constructs in
            # continuous mode, its prompts padded (held in test_torch_mla_engine)
            mcfg = get_config("deepseek-v2-lite-16b-smoke")
            meng = Engine(mcfg, lm.init_params(mcfg, torch.Generator().manual_seed(0)),
                          max_len=MAX_LEN, device="cpu")
            assert meng.continuous and meng.pad_prompts and meng.stats.mode == "continuous"
            continue
        if "embed_inputs" in kw:
            # as the reference: a stub frontend constructs in bucket mode (its
            # decode would need embeddings), and continuous mode is refused
            eng = Engine(cfg.with_(**kw), params, max_len=MAX_LEN, device="cpu")
            assert not eng.continuous and eng.stats.mode.startswith("bucket (mode='auto'")
            with pytest.raises(ValueError, match="mode='continuous' needs"):
                Engine(cfg.with_(**kw), params, max_len=MAX_LEN, mode="continuous",
                       device="cpu")
            continue
        # ported: attention mixed with Mamba under one shared decode position
        # serves in bucket mode (jamba; held in test_torch_zoo_jamba), and
        # continuous mode is refused, as in the reference
        mcfg = cfg.with_(**kw)
        eng = Engine(mcfg, lm.init_params(mcfg, torch.Generator().manual_seed(0)),
                     max_len=MAX_LEN, device="cpu")
        assert not eng.continuous and not eng.pad_prompts
        assert eng.stats.mode.startswith("bucket (mode='auto': pattern ('attn', 'mamba')")
        with pytest.raises(ValueError, match="mode='continuous' needs"):
            Engine(mcfg, params, max_len=MAX_LEN, mode="continuous", device="cpu")


def test_recurrent_pattern_serves_exact_length_buckets():
    """The reference's check (``tests/serving/test_lm_engine.py``): rwkv
    cannot mask pad tokens out of its state, so prompts keep their exact
    length (batch bucketing only), in both modes, and the ids equal the
    unbatched prefill + decode."""
    cfg = get_config("rwkv6-1.6b-smoke")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = _ref_generate(params, prompts, 4, cfg=cfg)
    for mode in ("auto", "bucket"):
        eng = Engine(cfg, params, max_len=MAX_LEN, batch_buckets=(2,), mode=mode, device="cpu")
        assert not eng.pad_prompts and eng.prompt_bucket(11) == 11
        assert np.array_equal(eng.generate(prompts, 4), want), mode
        assert PrefillBucket(2, 11) in eng.stats.buckets  # exact, not pow2


def test_default_device_is_cuda():
    """No device means the card; without one the engine refuses rather than
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg, params = _fixture()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
