"""Training on the port (``repro_torch/{optim,checkpoint,runtime}``,
``models/*.py``'s losses and ``remat``) against the JAX package, on the
same weights (the reference's ``init_params``, carried across with
``convert.params_from_numpy``) and the same numpy batches.

* Loss and gradient parity, one case per family: qwen3 (GQA, qk-norm,
  RoPE), deepseek-moe (MoE), deepseek-v2-lite (MLA), rwkv6 (WKV), jamba
  (Mamba + MoE) and vggt, each gradient leaf by relative L2 against
  ``jax.value_and_grad``; ``remat=True`` and ``"dots"`` against
  ``remat=False``.
* A 10-step trajectory of ``make_train_step`` on the reference's tiny
  qwen3 (``tests/test_system.py``).
* The reference's runtime tests (``tests/runtime/test_checkpoint.py``) and
  system properties (``tests/test_system.py``), ported.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models import vggt as jvggt
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointMismatch
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.model_quant import quantize_lm
from repro_torch.core.versaq import W4A8, QuantPolicy
from repro_torch.data.pipeline import DataConfig, ShardedLoader, scene_batch, token_batch
from repro_torch.models import lm, vggt
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig, lm_loss, make_train_step
from repro_torch.serving.vggt_engine import VGGTEngine
from repro_torch.tree import tree_map, tree_paths
from tests.test_torch_lm import flatten_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

KEY = jax.random.PRNGKey(0)
TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64)

# Loss and gradients against jax.value_and_grad (float32 both sides, sums
# in other orders).  Readings: the loss 0-1.5e-7 relative, the worst
# gradient leaf 7.9e-7 (vggt), 1.2-1.4e-6 (qwen3, deepseek-moe, MLA) and
# 7.2-8.8e-6 (rwkv6's ``bonus``, jamba's ``w_xproj``: a recurrence sums
# over time).
LOSS_REL, GRAD_REL = 1e-5, 1e-4
# remat recomputes the same operations on the same inputs: readings 0.
REMAT_REL = 1e-6

FAMILIES = {
    "qwen3": ("qwen3-14b-smoke", dict(n_layers=2)),
    "deepseek-moe": ("deepseek-moe-16b-smoke", dict(n_layers=2)),
    "deepseek-v2-lite": ("deepseek-v2-lite-16b-smoke", dict(n_layers=2)),
    "rwkv6": ("rwkv6-1.6b-smoke", dict(n_layers=2)),
    "jamba": ("jamba-v0.1-52b-smoke", dict(n_layers=2, pattern=("mamba", "attn"), moe_period=2)),
    "vggt": ("vggt-1b-smoke", dict(n_layers=1, layerscale_init=0.2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread: its smoke-size tensors gain
    nothing from more, and under ``pytest -n`` the workers' thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np_paths(tree, prefix: str = "") -> dict:
    """A ``flatten_jax`` tree's arrays by the port's dotted paths (a
    flattened norm's static ``kind``/``eps`` and absent biases skipped)."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() if k not in ("kind", "eps")
                for p, v in _np_paths(t, f"{prefix}.{k}" if prefix else k).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _np_paths(t, f"{prefix}.{i}" if prefix else str(i)).items()}
    return {} if tree is None else {prefix: np.asarray(tree)}


def _batch(name, cfg):
    if name == "vggt":
        return scene_batch(2, 2, 16, cfg.d_model, 3)
    return token_batch(DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=16), 3)


def _port_grads(name, cfg, tree_np, batch, remat):
    params = tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tree_np))
    if name == "vggt":
        loss = vggt.reconstruction_loss(cfg, params, batch, remat=remat)
    else:
        loss = lm_loss(cfg, params, batch, remat=remat)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in tree_paths(params).items()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_gradients_match_reference(name):
    arch, kw = FAMILIES[name]
    jcfg, cfg = j_get_config(arch).with_(**kw), get_config(arch).with_(**kw)
    batch = _batch(name, cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if name == "vggt":
        jp = jvggt.init_params(jcfg, KEY)
        fn = lambda p: jvggt.reconstruction_loss(jcfg, p, jb)  # noqa: E731
    else:
        jp = jlm.init_params(jcfg, KEY)
        fn = lambda p: jtrainer.lm_loss(jcfg, p, jb)  # noqa: E731
    jloss, jgrads = jax.jit(jax.value_and_grad(fn))(jp)
    want = _np_paths(flatten_jax(jgrads))
    tree_np = flatten_jax(jp)

    loss, grads = _port_grads(name, cfg, tree_np, batch, remat=False)
    assert abs(loss - float(jloss)) <= LOSS_REL * abs(float(jloss)), (loss, float(jloss))
    assert grads.keys() == want.keys()
    worst = max((_rel(grads[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_REL, worst
    for policy in (True, "dots"):
        loss_r, grads_r = _port_grads(name, cfg, tree_np, batch, remat=policy)
        assert loss_r == loss
        worst = max((_rel(grads_r[k], grads[k]), k) for k in grads)
        assert worst[0] <= REMAT_REL, (policy, worst)


def test_remat_rejects_unknown_policy():
    cfg = get_config("qwen3-14b-smoke").with_(**TINY, n_layers=1)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm.init_params(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="remat='everything'"):
        lm_loss(cfg, params, token_batch(DataConfig(64, 2, 8), 0), remat="everything")


# ---------------------------------------------------------------------------
# the tiny qwen3 of tests/test_system.py: one 80-step port run, shared
# ---------------------------------------------------------------------------

TRAJ_STEPS = 10
# The 10-step trajectory against the reference's make_train_step (jit).
# Readings: losses 0-2.3e-7 relative, params after 10 steps 9.9e-7 (the
# worst leaf, ``embed.w``).
TRAJ_LOSS_REL, TRAJ_PARAM_REL = 1e-5, 1e-5


def _tiny_cfgs():
    return (j_get_config("qwen3-14b-smoke").with_(**TINY),
            get_config("qwen3-14b-smoke").with_(**TINY))


@pytest.fixture(scope="module")
def tiny_run():
    """80 steps from the reference's seed-0 init, as ``_train_tiny``."""
    jcfg, cfg = _tiny_cfgs()
    params = params_from_numpy(flatten_jax(jlm.init_params(jcfg, KEY)))
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=80))
    dc = DataConfig(vocab_size=64, batch=8, seq_len=32)
    losses, at_traj = [], None
    for s in range(80):
        params, opt, m = step(params, opt, token_batch(dc, s))
        losses.append(float(m["loss"]))
        if s + 1 == TRAJ_STEPS:
            at_traj = {k: v.clone().numpy() for k, v in tree_paths(params).items()}
    return {"cfg": cfg, "params": params, "losses": losses, "at_traj": at_traj}


def test_trajectory_matches_reference(tiny_run):
    jcfg, _ = _tiny_cfgs()
    jp = jax.tree.map(jnp.asarray, jlm.init_params(jcfg, KEY))
    jopt = jadamw.init(jp)
    jstep = jax.jit(jtrainer.make_train_step(
        jcfg, jadamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=80)))
    dc = jpipe.DataConfig(vocab_size=64, batch=8, seq_len=32)
    for s in range(TRAJ_STEPS):
        jp, jopt, m = jstep(jp, jopt, jpipe.token_batch(dc, s))
        got = tiny_run["losses"][s]
        assert abs(got - float(m["loss"])) <= TRAJ_LOSS_REL * float(m["loss"]), (s, got)
    want = _np_paths(flatten_jax(jp))
    worst = max((_rel(tiny_run["at_traj"][k], want[k]), k) for k in want)
    assert worst[0] <= TRAJ_PARAM_REL, worst


def test_training_learns(tiny_run):
    losses = tiny_run["losses"]
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])


def test_quantized_model_preserves_trained_behaviour(tiny_run):
    """W4A8 VersaQ keeps greedy predictions close to the fp model; VersaQ
    W4A4 is no worse than RTN W4A4 by more than 0.02."""
    cfg, params = tiny_run["cfg"], tiny_run["params"]
    toks = torch.as_tensor(token_batch(DataConfig(vocab_size=64, batch=8, seq_len=32), 999)
                           ["tokens"])
    with torch.no_grad():
        ref_top1 = lm.forward(cfg, params, toks)[0].argmax(-1)

        def agree(policy):
            out, _ = lm.forward(cfg, quantize_lm(cfg, params, policy), toks)
            return float((out.argmax(-1) == ref_top1).float().mean())

        versaq_w4a8 = agree(W4A8)
        rtn_w4a4 = agree(QuantPolicy(4, 4, "rtn"))
        versaq_w4a4 = agree(QuantPolicy(4, 4, "versaq"))
    assert versaq_w4a8 > 0.9, versaq_w4a8
    assert versaq_w4a4 >= rtn_w4a4 - 0.02, (versaq_w4a4, rtn_w4a4)


def test_vggt_train_quantize_serve_pipeline():
    """Train VGGT-mini for 40 steps on synthetic scenes, quantize it W4A8
    and serve it through ``VGGTEngine``: points within 0.25 rel L2 of the
    fp engine's (the reference serves through ``vggt_serve``)."""
    cfg = get_config("vggt-1b-smoke").with_(layerscale_init=0.2)
    params = params_from_numpy(flatten_jax(
        jvggt.init_params(j_get_config("vggt-1b-smoke").with_(layerscale_init=0.2), KEY)))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    opt = adamw.init(params)
    step = make_train_step(cfg, opt_cfg, lambda p, b: vggt.reconstruction_loss(cfg, p, b))
    losses = []
    for s in range(40):
        params, opt, m = step(params, opt, scene_batch(4, 3, 64, cfg.d_model, s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], (losses[0], losses[-1])

    scenes = torch.as_tensor(scene_batch(2, 3, 64, cfg.d_model, 1000)["patches"])
    ref = VGGTEngine(cfg, params, device="cpu").infer(scenes)
    got = VGGTEngine(cfg, params, policy=W4A8, device="cpu").infer(scenes)
    rel = float(torch.linalg.norm(got["points"] - ref["points"])
                / torch.linalg.norm(ref["points"]))
    assert rel < 0.25, rel


# ---------------------------------------------------------------------------
# tests/runtime/test_checkpoint.py, ported
# ---------------------------------------------------------------------------


def _tiny_cfg():
    return get_config("qwen3-14b-smoke").with_(**TINY)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)},
            "s": adamw.AdamWState(torch.tensor(7, dtype=torch.int32), {"m": torch.ones(2)},
                                  {"m": torch.zeros(2)})}
    mgr.save(5, tree, meta={"next_step": 5})
    assert sorted(os.listdir(tmp_path / "step_000000005")) == ["arrays.npz", "manifest.json"]
    got, meta, step = mgr.restore(tree)
    assert step == 5 and meta["next_step"] == 5
    assert isinstance(got["s"], adamw.AdamWState)
    assert got["b"]["c"].dtype == torch.bfloat16
    for path, x in tree_paths(tree).items():
        assert torch.equal(tree_paths(got)[path], x), path


def test_restore_matches_paths_not_positions(tmp_path):
    """Two equal-shaped leaves under keys inserted in another order land
    where their paths say (``jax.tree`` sorts keys; the port's dicts keep
    insertion order)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"wq": torch.full((4, 4), 1.0), "wk": torch.full((4, 4), 2.0)})
    got, _, _ = mgr.restore({"wk": torch.zeros(4, 4), "wq": torch.zeros(4, 4)})
    assert list(got) == ["wk", "wq"]
    assert float(got["wq"][0, 0]) == 1.0 and float(got["wk"][0, 0]) == 2.0


@pytest.mark.parametrize("template", [
    {"a": torch.zeros(4), "b": torch.zeros(2)},
    {"a": torch.zeros(5)},
    {"a": torch.zeros(4, dtype=torch.bfloat16)},
], ids=["paths", "shape", "dtype"])
def test_restore_into_another_structure_raises(tmp_path, template):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(4.0)})
    with pytest.raises(CheckpointMismatch):
        mgr.restore(template)


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(4.0)}
    mgr.save(1, tree)
    mgr.save(2, tree_map(lambda x: x + 1, tree))
    path = os.path.join(str(tmp_path), "step_000000002", "arrays.npz")
    with open(path, "r+b") as f:  # corrupt the newest
        f.seek(-8, 2)
        f.write(b"XXXXXXXX")
    got, _, step = mgr.restore(tree)
    assert step == 1
    assert torch.equal(got["a"], torch.arange(4.0))


def test_checksum_mismatch_falls_back(tmp_path):
    """A flipped byte inside a leaf's array (the archive still reads)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(4.0)})
    mgr.save(2, {"a": torch.arange(4.0) + 1})
    path = tmp_path / "step_000000002" / "arrays.npz"
    data = dict(np.load(path))
    data["a0"] = data["a0"] + 1
    np.savez(path, **data)
    _, _, step = mgr.restore({"a": torch.zeros(4)})
    assert step == 1


def test_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.zeros(2)})
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_restart_exactness(tmp_path):
    """Kill at step 30, resume: the same losses and final params as the
    uninterrupted run, bit for bit on the CPU."""
    cfg = _tiny_cfg()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    dc = DataConfig(vocab_size=64, batch=4, seq_len=32)
    tc = TrainerConfig(total_steps=50, checkpoint_every=10, log_every=1000)

    t_full = Trainer(cfg, opt, dc, tc, str(tmp_path / "full"), device="cpu")
    hist_full = t_full.run()["history"]

    t_crash = Trainer(cfg, opt, dc, tc, str(tmp_path / "crash"), device="cpu")
    t_crash.fail_at = 30
    with pytest.raises(RuntimeError, match="injected failure"):
        t_crash.run()
    t_resume = Trainer(cfg, opt, dc, tc, str(tmp_path / "crash"), device="cpu")
    assert t_resume.start_step == 30
    hist_resume = t_resume.run()["history"]

    full_tail = {h["step"]: h["loss"] for h in hist_full if h["step"] >= 30}
    assert {h["step"]: h["loss"] for h in hist_resume} == full_tail
    want = tree_paths({"params": t_full.params, "opt": t_full.opt_state})
    for path, x in tree_paths({"params": t_resume.params, "opt": t_resume.opt_state}).items():
        assert torch.equal(x, want[path]), path


def test_data_pipeline_step_seeded():
    dc = DataConfig(vocab_size=97, batch=4, seq_len=16, seed=3)
    b1 = token_batch(dc, 42)
    np.testing.assert_array_equal(b1["tokens"], token_batch(dc, 42)["tokens"])
    assert not np.array_equal(b1["tokens"], token_batch(dc, 43)["tokens"])
    ref = jpipe.token_batch(jpipe.DataConfig(vocab_size=97, batch=4, seq_len=16, seed=3), 42)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[k], ref[k])
        assert b1[k].dtype == ref[k].dtype


def test_sharded_loader_single_process():
    dc = DataConfig(vocab_size=50, batch=4, seq_len=8, seed=1)
    loader = ShardedLoader(dc, start_step=5)
    for step in (5, 6):
        got = next(loader)
        np.testing.assert_array_equal(got["tokens"], token_batch(dc, step)["tokens"])


def test_straggler_watchdog_flags_injected_slow_step(tmp_path):
    cfg = _tiny_cfg()
    dc = DataConfig(vocab_size=64, batch=4, seq_len=32)
    tc = TrainerConfig(total_steps=20, checkpoint_every=100, log_every=1000,
                       straggler_factor=3.0)
    t = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), dc, tc, str(tmp_path), device="cpu")
    import time as _time

    real_step = t._step
    calls = {"n": 0}

    def slow_step(*a):
        calls["n"] += 1
        if calls["n"] == 15:
            _time.sleep(1.0)  # inject a straggler
        return real_step(*a)

    t._step = slow_step
    res = t.run()
    assert 14 in res["stragglers"], res["stragglers"]


def test_trainer_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        Trainer(_tiny_cfg(), adamw.AdamWConfig(), DataConfig(64, 2, 8),
                TrainerConfig(total_steps=1), str(tmp_path))
