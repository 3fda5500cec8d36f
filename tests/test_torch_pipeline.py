"""The port's GPipe pipeline (``parallel/pipeline.py``) on 4 gloo ranks,
started once for the file (``tests/torch_ranks.py::pipeline``): equal to the
stack applied in sequence (``rtol=1e-4, atol=1e-5``, the reference's
``tests/parallel/test_pipeline.py``) and to the reference's
``pipeline_apply`` on the same numpy weights (run meanwhile in a process of
4 host devices), on every rank; ``bubble_fraction`` equals the
reference's."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_ranks
from repro.parallel.pipeline import bubble_fraction as j_bubble_fraction
from repro_torch.parallel.pipeline import bubble_fraction
from torch_dist import ROOT, run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WORLD = 4
RTOL, ATOL = 1e-4, 1e-5

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.pipeline import pipeline_apply
d = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("pipe",))
got = pipeline_apply(mesh, lambda p, h: jnp.tanh(h @ p), jnp.asarray(d["w"]),
                     jnp.asarray(d["x"]), n_micro=int(d["n_micro"]))
np.save(sys.argv[2], np.asarray(got))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_ranks")
    w, x = torch_ranks.pipeline_inputs()
    np.savez(out / "inputs.npz", w=w, x=x, n_micro=torch_ranks.PIPE_MICRO)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = {}

    def reference():
        ref["run"] = subprocess.run(
            [sys.executable, "-c", _REFERENCE, str(out / "inputs.npz"), str(out / "ref.npy")],
            capture_output=True, text=True, env=env, timeout=600)

    th = threading.Thread(target=reference)
    th.start()
    run_ranks(WORLD, "pipeline", out, timeout=600)
    th.join()
    assert ref["run"].returncode == 0, ref["run"].stderr[-3000:]
    got = [torch.load(out / f"pipeline{r}.pt", weights_only=False)["got"].numpy()
           for r in range(WORLD)]
    return got, np.load(out / "ref.npy")


def test_pipeline_matches_sequential(results):
    w, x = torch_ranks.pipeline_inputs()
    want = torch.as_tensor(x)
    for s in range(torch_ranks.PIPE_S):
        want = torch_ranks.stage_fn(torch.as_tensor(w[s]), want)
    for got in results[0]:  # the last stage's outputs reach every rank
        np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


def test_pipeline_matches_the_reference_pipeline(results):
    got, ref = results
    for g in got:
        np.testing.assert_allclose(g, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stages,micro", [(4, 4), (4, 28), (1, 8), (8, 1), (2, 16)])
def test_bubble_fraction_equals_the_reference(stages, micro):
    assert bubble_fraction(stages, micro) == j_bubble_fraction(stages, micro)
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-9
    assert bubble_fraction(4, 28) < 0.1
