"""The port's int8 error-feedback gradient all-reduce
(``parallel/compression.py``) and ``runtime.trainer.make_ddp_compressed_step``
on 4 gloo ranks, started once for the file (``tests/torch_ranks.py::
compression``), against the JAX package's.

The reference's ``compressed_psum`` cannot run at N > 1 devices here (its
own ``tests/parallel/test_compression.py`` fails on this JAX), so the oracle
is the reference's function under ``jax.vmap(..., axis_name="d")`` on one CPU
device, over the same numpy gradients: every rank's output and new error
state, step after step, within 1e-6 of the oracle's scale.  Then the
reference test's properties: the mean within int8 resolution (rel < 0.03),
error feedback's accumulated bias (rel < 0.02 over 40 steps), the small
leaves' plain mean, and the DDP step's convergence (the last loss under
0.9x the first and within 15% of the single-device step's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.parallel import compression as jcomp
from torch_dist import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WORLD = 4
ORACLE_REL = 1e-6
# the reference's bounds (tests/parallel/test_compression.py)
MEAN_REL, EF_REL, DDP_DROP, DDP_TRACK = 0.03, 0.02, 0.9, 0.15


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("compression_ranks")
    seconds = run_ranks(WORLD, "compression", out, timeout=600)
    print(f"{WORLD} gloo ranks: {seconds:.1f}s")
    return [torch.load(out / f"compression{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def oracle():
    """The reference's compressed_psum, chained over every step's inputs."""
    f = jax.jit(jax.vmap(lambda g, e: jcomp.compressed_psum(g, "d", WORLD, e), axis_name="d"))
    e = jnp.zeros((WORLD, 1000), jnp.float32)
    outs, errs = [], []
    for g in torch_ranks.psum_inputs(WORLD):
        o, e = f(jnp.asarray(g), e)
        outs.append(np.asarray(o))
        errs.append(np.asarray(e))
    return np.stack(outs), np.stack(errs)  # [steps, rank, 1000]


@pytest.mark.parametrize("field", ["out", "err"])
def test_compressed_psum_matches_the_reference_oracle(ranks, oracle, field):
    want_all = oracle[0] if field == "out" else oracle[1]
    worst = 0.0
    for rank, r in enumerate(ranks):
        got = r["psum"][field].numpy()
        want = want_all[:, rank]
        scale = np.abs(want).max(axis=-1, keepdims=True)
        rel = np.abs(got - want) / scale
        worst = max(worst, float(rel.max()))
        assert rel.max() <= ORACLE_REL, (rank, float(rel.max()))
    print(f"compressed_psum {field}: worst |diff| / max |oracle| {worst:.3g}")


def test_compressed_psum_mean_and_error_feedback(ranks):
    grads = torch_ranks.psum_inputs(WORLD)
    want = grads[0].mean(0)
    for r in ranks:
        out = r["psum"]["out"].numpy()
        assert np.linalg.norm(out[0] - want) / np.linalg.norm(want) < MEAN_REL
        assert float(np.abs(r["psum"]["err"][0].numpy()).max()) > 0
        # every rank holds the same mean
        np.testing.assert_array_equal(out, ranks[0]["psum"]["out"].numpy())
    acc_c = ranks[0]["psum"]["out"].numpy()[1:].sum(0)
    acc_t = np.stack([g.mean(0) for g in grads[1:]]).sum(0)
    rel = np.linalg.norm(acc_c - acc_t) / np.linalg.norm(acc_t)
    assert rel < EF_REL, rel
    print(f"error feedback: accumulated rel {rel:.3g} over {len(grads) - 1} steps")


def test_compressed_tree_psum_small_leaves_take_the_plain_mean(ranks):
    for r in ranks:
        t = r["tree"]
        # the small leaf: rank r holds r + 1 everywhere, so the mean is 2.5
        assert torch.equal(t["small"], torch.full((4, 10), 2.5))
        assert torch.equal(t["err_small"], torch.zeros(4, 10))
        # the large one went through compressed_psum (the first step above)
        assert torch.equal(t["big"], r["psum"]["out"][0])
        assert torch.equal(t["err_big"], r["psum"]["err"][0])
        assert t["in_place"]


def test_ddp_compressed_training_converges(ranks):
    losses = ranks[0]["ddp"]["losses"]
    base = ranks[0]["ddp"]["base"]
    for r in ranks:
        assert r["ddp"]["losses"] == losses  # the loss is averaged over the ranks
    assert losses[-1] < losses[0] * DDP_DROP, (losses[0], losses[-1])
    assert abs(losses[-1] - base[-1]) / base[-1] < DDP_TRACK, (losses[-1], base[-1])
    # the int8 bytes a rank sends a step: N (1 + 1/4) over the large leaves
    assert ranks[0]["ddp"]["wire_bytes"] > 0
    print(f"DDP compressed on {WORLD} ranks: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(single device {base[-1]:.4f}), {ranks[0]['ddp']['seconds']:.1f}s for "
          f"{len(losses)} steps, {ranks[0]['ddp']['wire_bytes']:.0f} int8 bytes a step")
