"""The port's LM ``Engine`` serving ``deepseek-moe-16b-smoke`` on the CPU,
token for token against the JAX package's engine in the same mode, with
``quality`` (fp) and ``balanced`` (W4A8) tiers: bucket mode, and the
continuous scheduler with requests joining mid-decode.

Expert capacity makes a MoE model's outputs depend on the batch it runs
in: a decode step keeps one slot an expert (cap = ceil(n * 2 * 1.25 / 8)
for n <= 3 rows), so of two co-batched rows routed to one expert the later
one loses it, and a prefill's capacity follows the wave's token count.  The
reference's own bucket and continuous modes therefore disagree on these
requests (``test_modes_differ_in_the_reference_too``), and each of the
port's modes is held against the reference's same mode on the same
requests in the same order.  Also: the launcher serves the config, MLA
and Mamba are still refused, and an embedding-input config constructs in
bucket mode as the reference's does.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.serving.engine import Engine

from test_torch_launch_serve import _launch
from test_torch_lm import flatten_jax

ARCH = "deepseek-moe-16b-smoke"
W4A8 = PrecisionPlan(default="w4a8", use_kernel=True)
TIERS = ("quality", "balanced")
N_STEPS = 12
BUCKET = dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0)
CONTINUOUS = dict(max_len=64, max_batch=4, batch_buckets=(1, 2, 4), max_wait_s=0.0,
                  decode_steps_per_poll=4)


@functools.lru_cache(maxsize=1)
def _setup():
    jcfg = j_get_config(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH), jp, params_from_numpy(flatten_jax(jp))


def _engines(mode, kw):
    jcfg, cfg, jp, tp = _setup()
    return (JEngine(jcfg, jp, tiers={"quality": None, "balanced": jvq.W4A8}, mode=mode, **kw),
            Engine(cfg, tp, tiers={"quality": None, "balanced": W4A8}, mode=mode, device="cpu",
                   **kw))


def _prompts(n=8):
    return mixed_len_prompts(get_config(ARCH).vocab_size, n, 12)  # 12 and 9 tokens: l16


def _serve_bucket(eng):
    reqs = [eng.enqueue(p, N_STEPS, tier=TIERS[i % 2]) for i, p in enumerate(_prompts())]
    eng.flush()
    return [np.asarray(r.result()) for r in reqs]


def _serve_continuous(eng):
    """Two requests first, three joining after one burst, three after the
    next, then drain: the same script on either engine."""
    prompts = _prompts()
    reqs = [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (0, 1)]
    eng.poll()
    reqs += [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (2, 3, 4)]
    eng.poll()
    reqs += [eng.enqueue(prompts[i], N_STEPS, tier=TIERS[i % 2]) for i in (5, 6, 7)]
    eng.flush()
    return [np.asarray(r.result()) for r in reqs]


@functools.lru_cache(maxsize=None)
def _served(mode):
    jeng, teng = _engines(mode, BUCKET if mode == "bucket" else CONTINUOUS)
    serve = _serve_bucket if mode == "bucket" else _serve_continuous
    return jeng, teng, serve(jeng), serve(teng)


def test_bucket_mode_matches_reference_engine():
    jeng, teng, want, got = _served("bucket")
    assert teng.stats.mode == "bucket"
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == np.int32 and g.shape == (N_STEPS,)
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} ({TIERS[i % 2]})")
    assert {str(b) for b in teng.stats.buckets} == {str(b) for b in jeng.stats.buckets}
    for b, s in teng.stats.buckets.items():
        js = next(v for k, v in jeng.stats.buckets.items() if str(k) == str(b))
        assert (s.calls, s.items, s.tokens, s.compiles) == (js.calls, js.items, js.tokens,
                                                            js.compiles), b


def test_continuous_mode_matches_reference_engine():
    jeng, teng, want, got = _served("auto")
    assert teng.continuous and teng.stats.mode == "continuous"
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} ({TIERS[i % 2]})")
    js, ts = jeng.stats.scheduler, teng.stats.scheduler
    assert ts.admitted_mid_decode >= 1
    assert (ts.admitted, ts.admitted_mid_decode) == (js.admitted, js.admitted_mid_decode)


def test_modes_differ_in_the_reference_too():
    """Capacity couples co-batched rows, so bucket and continuous serving
    of the same requests emit other ids in the reference as in the port
    (and from the first token on, where a prefill wave differs)."""
    _, _, jb, tb = _served("bucket")
    _, _, jc, tc = _served("auto")
    assert not all(np.array_equal(a, b) for a, b in zip(jb, jc))
    assert [np.array_equal(a, b) for a, b in zip(tb, tc)] == \
        [np.array_equal(a, b) for a, b in zip(jb, jc)]


def test_launcher_serves_deepseek_moe_without_jax():
    out = _launch("--device", "cpu", "--arch", ARCH, "--tiers", "quality=fp,balanced=w4a8",
                  "--requests", "4", "--prompt-len", "8", "--gen", "8", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests -> 32 tokens" in out.stdout
    assert "scheduler: continuous" in out.stdout
    for tier in TIERS:
        assert f"{tier}:prefill:b" in out.stdout and f"{tier}:decode:b" in out.stdout


@pytest.mark.parametrize("kw,item", [(dict(mla=True), "item 7b"),
                                     (dict(pattern=("attn", "mamba"), n_layers=4), "item 9"),
                                     (dict(embed_inputs=True), "embedding inputs")])
def test_other_unported_kinds_still_raise(kw, item):
    jcfg, cfg, jp, tp = _setup()
    if item == "embedding inputs":
        # ported: the engine constructs in bucket mode and refuses continuous
        # mode, as the reference's does
        engines = (JEngine(jcfg.with_(**kw), jp, max_len=32),
                   Engine(cfg.with_(**kw), tp, max_len=32, device="cpu"))
        assert not any(e.continuous for e in engines)
        with pytest.raises(ValueError, match="mode='continuous' needs"):
            JEngine(jcfg.with_(**kw), jp, max_len=32, mode="continuous")
        with pytest.raises(ValueError, match="mode='continuous' needs"):
            Engine(cfg.with_(**kw), tp, max_len=32, mode="continuous", device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        Engine(cfg.with_(**kw), tp, max_len=32, device="cpu")
