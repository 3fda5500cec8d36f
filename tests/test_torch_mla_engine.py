"""The port's LM ``Engine`` serving ``deepseek-v2-lite-16b-smoke`` (MLA and
the MoE FFN) on the CPU, token for token against the JAX package's engine
in the same mode, with ``quality`` (fp) and ``balanced`` (W4A8) tiers:
bucket mode, and the continuous scheduler with requests joining
mid-decode.  A prompt runs through MLA's materialized branch at prefill and
its absorbed branch at decode, on both sides.

As for deepseek-moe-16b (``tests/test_torch_moe_engine.py``), expert
capacity couples the rows that share a batch, in the reference too, so each
of the port's modes is held against the reference's same mode on the same
requests in the same order, never against the other mode.  Also: the
reference's padded-prompt check for MLA (``tests/serving/
test_lm_engine.py::test_mla_padded_prompt_matches_unpadded_reference``),
``mode="auto"`` resolving to continuous, and the launcher serving the
config in a process where JAX cannot be imported.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, PrefillBucket

from test_torch_launch_serve import _launch
from test_torch_lm import REL_L2_FLIP, flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCH = "deepseek-v2-lite-16b-smoke"
W4A8 = PrecisionPlan(default="w4a8", use_kernel=True)
TIERS = ("quality", "balanced")
N_STEPS = 12
BUCKET = dict(max_len=32, max_batch=2, batch_buckets=(1, 2), max_wait_s=60.0)
CONTINUOUS = dict(max_len=64, max_batch=4, batch_buckets=(1, 2, 4), max_wait_s=0.0,
                  decode_steps_per_poll=4)


@functools.lru_cache(maxsize=None)
def _setup(dropless=False):
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    if dropless:  # capacity_factor = n_experts: routing drops no token
        jcfg = jcfg.with_(capacity_factor=float(jcfg.n_experts))
        cfg = cfg.with_(capacity_factor=float(cfg.n_experts))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(flatten_jax(jp))


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
    jcfg, cfg, jp, tp = _setup()
    kw = BUCKET if mode == "bucket" else CONTINUOUS
    jeng = JEngine(jcfg, jp, tiers={"quality": None, "balanced": jvq.W4A8}, mode=mode, **kw)
    teng = Engine(cfg, tp, tiers={"quality": None, "balanced": W4A8}, mode=mode, device="cpu",
                  **kw)
    serve = _serve_bucket if mode == "bucket" else _serve_continuous
    return jeng, teng, serve(jeng), serve(teng)


def _replay(jeng, teng, tier, idx, ids, n):
    """Both engines' ``tier`` trees teacher-forced on the reference
    engine's ids ``ids`` ([2, N_STEPS]) for the bucket that served requests
    ``idx`` (left-padded to its prompt bucket): the prefill's and the first
    ``n`` decode steps' last-position logits, [n + 1, 2, V] each side."""
    import torch

    jcfg, cfg = jeng.cfg, teng.cfg
    prompts = [_prompts()[i] for i in idx]
    width = teng.prompt_bucket(max(len(p) for p in prompts))
    toks = np.stack([np.pad(p, (width - len(p), 0)) for p in prompts]).astype(np.int32)
    pad = np.array([width - len(p) for p in prompts], np.int32)
    jt, tt = jeng.tier_params(tier), teng.tier_params(tier)
    jc, tc = jlm.init_cache(jcfg, 2, BUCKET["max_len"]), lm.init_cache(cfg, 2, BUCKET["max_len"])
    jl, jc = jlm.forward(jcfg, jt, jnp.asarray(toks), cache=jc, mode="prefill",
                         pad_lens=jnp.asarray(pad))
    with torch.inference_mode():
        tl, tc = lm.forward(cfg, tt, torch.as_tensor(toks).long(), cache=tc, mode="prefill",
                            pad_lens=torch.as_tensor(pad).long())
        want, got = [np.asarray(jl[:, -1])], [tl[:, -1].numpy()]
        for s in range(n):
            jl, jc = jlm.decode_step(jcfg, jt, jnp.asarray(ids[:, s]), jc,
                                     pad_lens=jnp.asarray(pad))
            tl, tc = lm.decode_step(cfg, tt, torch.as_tensor(ids[:, s]).long(), tc,
                                    pad_lens=torch.as_tensor(pad).long())
            want.append(np.asarray(jl[:, 0]))
            got.append(tl[:, 0].numpy())
    return np.stack(want), np.stack(got)


def _hold_ids(jeng, teng, want, got, tier, idx):
    """The ids of the bucket that served requests ``idx`` against the
    reference's, token for token, or up to a rounding tie: where a W4A8
    request's ids part, both trees teacher-forced on the reference's ids
    must (a) give logits within the flip bound of each other at every step
    up to the parting one, (b) each pick, there, the token its engine
    emitted, and (c) make those two tokens a tie within the two models'
    own disagreement (the reference scores the port's pick no lower than
    its own less the largest logit gap on that row).  A last-bit difference
    of the norms flips an int8 rounding in the compressed cache at a tie
    (one c_kv entry at 52.500004 steps of its scale, request 1, decode step
    1), and the cascade moves a later near tie."""
    parts = [int(np.argmax(want[i] != got[i])) if not np.array_equal(want[i], got[i])
             else None for i in idx]
    if all(p is None for p in parts):
        return
    assert tier == "balanced", (tier, parts)  # the fp tier's ids are held exactly
    t = min(p for p in parts if p is not None)
    ids = np.stack([want[i] for i in idx]).astype(np.int32)
    jl, tl = _replay(jeng, teng, tier, idx, ids, t)
    for s in range(t + 1):
        assert _rel(tl[s], jl[s]) < REL_L2_FLIP, (idx, s)
    for row, i in enumerate(idx):
        if parts[row] != t:
            continue
        j_row, t_row = jl[t, row], tl[t, row]
        assert j_row.argmax() == want[i][t] and t_row.argmax() == got[i][t], (i, t)
        gap = np.abs(j_row - t_row).max()
        assert j_row[got[i][t]] >= j_row[want[i][t]] - gap, (i, t, gap)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bucket_mode_matches_reference_engine():
    """Bucket mode: each tier's requests coalesce in pairs of the l16
    bucket (12 and 9 tokens, left-padded); ids as ``_hold_ids`` holds them,
    the buckets' stats equal."""
    jeng, teng, want, got = _served("bucket")
    assert teng.stats.mode == "bucket"
    for g in got:
        assert g.dtype == np.int32 and g.shape == (N_STEPS,)
    for tier in TIERS:
        mine = [i for i in range(len(got)) if TIERS[i % 2] == tier]
        for idx in zip(mine[0::2], mine[1::2]):
            _hold_ids(jeng, teng, want, got, tier, idx)
    assert {str(b) for b in teng.stats.buckets} == {str(b) for b in jeng.stats.buckets}
    for b, s in teng.stats.buckets.items():
        js = next(v for k, v in jeng.stats.buckets.items() if str(k) == str(b))
        assert (s.calls, s.items, s.tokens, s.compiles) == (js.calls, js.items, js.tokens,
                                                            js.compiles), b


def test_continuous_mode_matches_reference_engine():
    """``mode="auto"`` resolves to continuous (an attention-only pattern
    pads prompts), as the reference's does; every request's ids equal the
    reference's continuous engine's, with admissions mid-decode."""
    jeng, teng, want, got = _served("auto")
    assert teng.continuous and teng.pad_prompts and teng.stats.mode == "continuous"
    assert jeng.continuous and jeng.pad_prompts
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape == (N_STEPS,)
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} ({TIERS[i % 2]})")
    js, ts = jeng.stats.scheduler, teng.stats.scheduler
    assert ts.admitted_mid_decode >= 1
    assert (ts.admitted, ts.admitted_mid_decode) == (js.admitted, js.admitted_mid_decode)


def _ref_generate(cfg, params, prompts, n_steps, max_len=32):
    """The reference test's unbatched, unpadded prefill + greedy decode, on
    the port."""
    import torch

    toks = torch.as_tensor(np.asarray(prompts)).long()
    cache = lm.init_cache(cfg, toks.shape[0], max_len)
    with torch.inference_mode():
        logits, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill")
        tok = logits[:, -1].argmax(-1)
        out = [tok]
        for _ in range(n_steps - 1):
            logits, cache = lm.decode_step(cfg, params, tok, cache)
            tok = logits[:, 0].argmax(-1)
            out.append(tok)
    return torch.stack(out, dim=1).numpy().astype(np.int32)


def test_padded_prompt_matches_unpadded_reference():
    """The reference's MLA check: 12-token prompts pad into the l16 bucket
    (left pads masked in the materialized prefill and in the absorbed
    decode), with capacity boosted so routing drops no token; the ids equal
    the unpadded prefill + decode, the port's and the reference's engine's
    alike."""
    jcfg, cfg, jp, tp = _setup(dropless=True)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 12), 0,
                                            cfg.vocab_size)).astype(np.int32)
    eng = Engine(cfg, tp, max_len=32, batch_buckets=(2,), device="cpu")
    got = eng.generate(prompts, 4)
    assert np.array_equal(got, _ref_generate(cfg, tp, prompts, 4))
    assert PrefillBucket(2, 16) in eng.stats.buckets
    want = JEngine(jcfg, jp, max_len=32, batch_buckets=(2,)).generate(jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_launcher_serves_deepseek_v2_lite_without_jax():
    out = _launch("--device", "cpu", "--arch", ARCH, "--tiers", "quality=fp,balanced=w4a8",
                  "--requests", "4", "--prompt-len", "8", "--gen", "8", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests -> 32 tokens" in out.stdout
    assert "scheduler: continuous" in out.stdout
    for tier in TIERS:
        assert f"{tier}:prefill:b" in out.stdout and f"{tier}:decode:b" in out.stdout
