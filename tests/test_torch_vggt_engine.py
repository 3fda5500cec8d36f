"""VGGTEngine of the PyTorch port on the CPU (``device="cpu"``): bucket
reuse, padding, micro-batch split/merge, quarantine, the default device,
and parity with the JAX engine on the same requests.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import versaq as jvq
from repro.core.precision.plan import PrecisionPlan as JPlan
from repro.models import vggt as jvggt
from repro.serving.vggt_engine import VGGTEngine as JVGGTEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.data.pipeline import scene_batch
from repro_torch.models import vggt
from repro_torch.serving.batching import DeadlineExceeded, NumericFault
from repro_torch.serving.vggt_engine import Bucket, VGGTEngine
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

PLAN = PrecisionPlan(default="w4a8", use_kernel=True)
# the forward-parity bound of tests/test_torch_vggt.py (unmasked buckets)
REL_L2 = 1e-3


def _flatten_jax(tree):
    if isinstance(tree, jvq.Norm):
        return {"g": np.asarray(tree.g), "b": None if tree.b is None else np.asarray(tree.b),
                "kind": tree.kind, "eps": tree.eps}
    if isinstance(tree, dict):
        return {k: _flatten_jax(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


@functools.lru_cache(maxsize=1)
def _fixture():
    kw = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
              layerscale_init=0.2)
    jcfg = j_get_config("vggt-1b-smoke").with_(**kw)
    jp = jvggt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config("vggt-1b-smoke").with_(**kw), jp, params_from_numpy(_flatten_jax(jp))


def _scenes(n, frames=2, patches=24, seed=0):
    return scene_batch(n, frames, patches, 64, seed)["patches"]


def _engine(**kw):
    _, cfg, _, tp = _fixture()
    return VGGTEngine(cfg, tp, device="cpu", **kw)


def test_default_device_is_cuda():
    """No device means the card; without one the engine refuses rather than
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, cfg, _, tp = _fixture()
    with pytest.raises(RuntimeError, match="CUDA"):
        VGGTEngine(cfg, tp)


def test_scene_batch_matches_reference():
    from repro.data.pipeline import scene_batch as j_scene_batch

    got, want = scene_batch(2, 3, 5, 16, step=4, seed=1), j_scene_batch(2, 3, 5, 16, 4, seed=1)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_bucket_cache_reuse():
    """An already-seen (batch, frames, patches) bucket is reused: it counts
    no new first use (the ``compiles`` field of the shared stats schema)."""
    eng = _engine(batch_buckets=(2, 4))
    eng.infer(_scenes(2, seed=0))
    assert eng.stats.compiles == 1 and len(eng.stats.buckets) == 1
    eng.infer(_scenes(2, seed=1))  # same bucket -> reused
    assert eng.stats.compiles == 1 and len(eng.stats.buckets) == 1 and eng.stats.calls == 2
    eng.infer(_scenes(3, seed=2))  # pads into b4
    eng.infer(_scenes(4, seed=3))
    assert eng.stats.compiles == 2
    b4 = eng.stats.buckets[Bucket(4, 2, 24)]
    assert b4.compiles == 1 and b4.calls == 2 and b4.padded_items == 1
    assert "b4xs2xp24" in eng.stats.format()
    assert eng.stats.summary()["totals"] == {"compiles": 2, "calls": 4, "items": 11,
                                             "tokens": 0}


@pytest.mark.parametrize("policy", [None, PLAN])
def test_batch_padding_matches_unpadded_forward(policy):
    eng = _engine(batch_buckets=(4,), policy=policy, attn_impl="two_stage")
    scenes = _scenes(3, seed=7)
    got = eng.infer(scenes)
    want = vggt.forward(eng.cfg, eng.params, torch.as_tensor(scenes))
    for k in ("pose", "points", "depth", "conf"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_patch_padding_masked_matches_unpadded_forward():
    eng = _engine(batch_buckets=(2,), pad_patches=True)
    scenes = _scenes(2, patches=20, seed=8)
    got = eng.infer(scenes)
    want = vggt.forward(eng.cfg, eng.params, torch.as_tensor(scenes))
    assert got["points"].shape == want["points"].shape  # padding sliced off
    assert Bucket(2, 2, 32) in eng.stats.buckets
    for k in ("pose", "points", "depth", "conf"):
        torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=2e-4)


def test_microbatch_split_merge_roundtrip():
    """Coalesced requests run as ONE forward and each caller gets exactly
    its own scenes back."""
    eng = _engine(batch_buckets=(4,), max_batch=4)
    reqs = [eng.enqueue(_scenes(1, seed=s)) for s in range(3)]
    assert eng.pending == 3 and not any(r.ready for r in reqs)
    eng.flush()
    assert eng.stats.calls == 1 and eng.pending == 0
    for s, r in enumerate(reqs):
        want = vggt.forward(eng.cfg, eng.params, torch.as_tensor(_scenes(1, seed=s)))
        for k in ("pose", "depth"):
            torch.testing.assert_close(r.result()[k], want[k], rtol=1e-5, atol=1e-5)


def test_numeric_quarantine_isolates_one_request():
    eng = _engine(batch_buckets=(2,), max_batch=2)
    bad = _scenes(1, seed=1)
    bad[0, 0, 0, 0] = np.nan
    good = eng.enqueue(_scenes(1, seed=0))
    poisoned = eng.enqueue(bad)  # fills the group: flushed together
    assert eng.stats.calls == 1
    assert np.isfinite(good.result()["pose"].numpy()).all()
    with pytest.raises(NumericFault):
        poisoned.result()
    assert eng.stats.scheduler.numeric_faults == 1


def test_poll_and_deadlines():
    eng = _engine(batch_buckets=(4,), max_batch=4, max_wait_s=0.0)
    late = eng.enqueue(_scenes(1, seed=0), deadline_s=0.0)
    eng.flush()
    with pytest.raises(DeadlineExceeded):
        late.result()
    assert eng.stats.scheduler.deadline_evictions == 1
    r = eng.enqueue(_scenes(1, seed=1))
    assert eng.poll() == 1 and r.ready
    pending = eng.enqueue(_scenes(1, seed=2))
    assert eng.abort() == 1
    with pytest.raises(RuntimeError):
        pending.result()


def test_matches_reference_engine():
    """Same weights, same requests, same plan and two-stage attention: the
    port's results equal the JAX engine's within the forward tolerance."""
    jcfg, cfg, jp, tp = _fixture()
    jeng = JVGGTEngine(jcfg, jp, policy=JPlan(default="w4a8", use_kernel=True),
                       attn_impl="two_stage", batch_buckets=(2,), max_batch=2)
    teng = VGGTEngine(cfg, tp, policy=PLAN, attn_impl="two_stage", batch_buckets=(2,),
                      max_batch=2, device="cpu")
    requests = [_scenes(1, seed=s) for s in range(3)]
    jreqs = [jeng.enqueue(jnp.asarray(x)) for x in requests]
    treqs = [teng.enqueue(x) for x in requests]
    jeng.flush()
    teng.flush()
    assert teng.stats.calls == jeng.stats.calls == 2
    for jr, tr in zip(jreqs, treqs):
        for k in ("pose", "points", "depth"):
            got, want = tr.result()[k].numpy(), np.asarray(jr.result()[k])
            assert got.shape == want.shape
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < REL_L2, (k, rel)


@pytest.mark.parametrize("pad_patches", [False, True])
def test_fused_plan_matches_reference_engine(pad_patches):
    """The fused plan (``fuse=True``: wqkv with the absorbed LayerNorm, wo
    and the whole FFN each one kernel launch) served by both engines on
    the same requests; with ``pad_patches`` the bucket is patch-padded and
    masked, so only the attention takes the emulation.  Held to the
    unfused bound: these requests read at most 9e-7."""
    jcfg, cfg, jp, tp = _fixture()
    kw = dict(attn_impl="two_stage", batch_buckets=(2,), max_batch=2, pad_patches=pad_patches)
    jeng = JVGGTEngine(jcfg, jp, policy=JPlan(default="w4a8", use_kernel=True, fuse=True), **kw)
    teng = VGGTEngine(cfg, tp, policy=PrecisionPlan(default="w4a8", fuse=True), device="cpu",
                      **kw)
    assert "wqkv" in teng.params["blocks"]["frame"]["attn"]
    patches = 20 if pad_patches else 24
    requests = [_scenes(1, patches=patches, seed=s) for s in range(3)]
    jreqs = [jeng.enqueue(jnp.asarray(x)) for x in requests]
    treqs = [teng.enqueue(x) for x in requests]
    jeng.flush()
    teng.flush()
    assert teng.stats.calls == jeng.stats.calls == 2
    if pad_patches:
        assert Bucket(2, 2, 32) in teng.stats.buckets
    for jr, tr in zip(jreqs, treqs):
        for k in ("pose", "points", "depth"):
            got, want = tr.result()[k].numpy(), np.asarray(jr.result()[k])
            assert got.shape == want.shape
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < REL_L2, (k, rel)
