"""The port's AdamW (``repro_torch/optim/adamw.py``) against the JAX
package's (``repro/optim/adamw.py``) on the same numpy inputs: the
warmup-cosine schedule, and five ``apply`` steps on a tree of matrices,
vectors and one bfloat16 leaf, with the global-norm clip active and not.

Both sides compute in float32 with the same operation order; the JAX side
runs op by op (no ``jit``, whose fusion may reorder arithmetic).  The
global norm sums in another order, 1.4e-7 apart; with the clip inactive
every leaf is equal to the last bit, with it active the clipped gradient
inherits that ulp and leaves read up to 1.6e-7 apart.  The bound is 1e-6
relative, on params, ``m``, ``v``, ``grad_norm`` and ``lr``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REL = 1e-6
CFG = dict(lr=3e-3, warmup_steps=3, total_steps=20, weight_decay=0.1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("step", [0, 2, 3, 11, 20, 35])
def test_schedule_matches_reference(step):
    """Steps 0, warmup-1, warmup, mid-run, total_steps and beyond."""
    want = jadamw.schedule(jadamw.AdamWConfig(**CFG), jnp.asarray(step, jnp.int32))
    got = adamw.schedule(adamw.AdamWConfig(**CFG), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= REL


def _tree(rng):
    return {
        "w": rng.normal(size=(16, 24)).astype(np.float32),
        "blocks": [{"a": rng.normal(size=(3, 8, 8)).astype(np.float32),
                    "g": (1 + 0.1 * rng.normal(size=(8,))).astype(np.float32)}],
        "b": rng.normal(size=(24,)).astype(np.float32),
        "half": rng.normal(size=(8, 16)).astype(np.float32),  # cast to bfloat16 below
    }


def _to_jax(tree):
    out = {k: jnp.asarray(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: jnp.asarray(v) for k, v in tree["blocks"][0].items()}]
    out["half"] = out["half"].astype(jnp.bfloat16)
    return out


def _to_torch(tree):
    out = {k: torch.tensor(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: torch.tensor(v) for k, v in tree["blocks"][0].items()}]
    out["half"] = out["half"].to(torch.bfloat16)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], f"{prefix}.{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in _flat(t, f"{prefix}.{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy()}
    return {prefix: np.asarray(tree.astype(jnp.float32))}


@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clip_active", "clip_inactive"])
def test_apply_five_steps_matches_reference(clip_norm):
    rng = np.random.default_rng(0)
    init = _tree(rng)
    jcfg = jadamw.AdamWConfig(**CFG, clip_norm=clip_norm)
    cfg = adamw.AdamWConfig(**CFG, clip_norm=clip_norm)
    jp, tp = _to_jax(init), _to_torch(init)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(5):
        g = _tree(np.random.default_rng(100 + step))
        jp, js, jm = jadamw.apply(jcfg, js, jp, _to_jax(g))
        tp, ts, tm = adamw.apply(cfg, ts, tp, _to_torch(g))
        clipped = float(jm["grad_norm"]) > clip_norm
        assert clipped == (clip_norm == 1.0)
        assert _rel(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"])) <= REL
        assert _rel(tm["lr"].numpy(), np.asarray(jm["lr"])) <= REL
        assert int(ts.step) == int(js.step) == step + 1
        for name, got, want in (("params", tp, jp), ("m", ts.m, js.m), ("v", ts.v, js.v)):
            got, want = _flat(got), _flat(want)
            assert got.keys() == want.keys()
            for path in want:
                r = _rel(got[path], want[path])
                assert r <= REL, f"step {step} {name}{path}: rel {r}"
    assert tp["half"].dtype == torch.bfloat16
    assert ts.m["half"].dtype == torch.float32


def test_apply_updates_in_place_and_decays_matrices_only():
    """Decoupled weight decay reaches ``ndim >= 2`` leaves only: with zero
    gradients a matrix shrinks by ``lr * wd`` and a vector stays put."""
    params = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    w_id = params["w"].data_ptr()
    cfg = adamw.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10, weight_decay=0.1)
    state = adamw.init(params)
    grads = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    out, state, m = adamw.apply(cfg, state, params, grads)
    assert out["w"].data_ptr() == w_id
    lr = float(m["lr"])
    torch.testing.assert_close(out["w"], torch.full((4, 4), 1 - lr * 0.1), rtol=0, atol=1e-7)
    torch.testing.assert_close(out["b"], torch.ones(4), rtol=0, atol=0)
