"""The port's examples and its training launcher run end to end on the
CPU (``--device cpu``), in processes where JAX and the JAX package cannot
be imported.  The examples print the lines the reference's example smoke
tests look for
(``tests/examples/test_{mixed_precision,observe_serving,serve_lm,serve_vggt}_smoke.py``;
the reference's ``quickstart.py`` and ``train_lm.py`` have none, so their
ports are held to the lines the reference's scripts print).

One line differs in value: the reference's mixed-precision example prints
``plan beats w4a4: True`` for its seed-0 weights (``jax.random``) under the
TPU roofline constants.  The port plans under the H100's constants on
torch's seed-0 weights, and at ``vggt-1b-smoke`` (LayerScale 1e-5) the
proxy errors of the planned plan and of uniform W4A4 are within each
other's spread across seeds (the plan beat W4A4 for 2 of seeds 0-5), so
the test holds that the comparison is printed, and that the planned plan
keeps uniform W4A4's modeled weight bytes."""
import pathlib
import re
import subprocess
import sys
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(example, *argv):
    code = ("import runpy, sys; sys.modules.update(jax=None, jaxlib=None, repro=None); "
            f"sys.argv = ['{example}'] + sys.argv[1:]; "
            f"runpy.run_path('{ROOT / 'examples' / example}', run_name='__main__')")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                          timeout=480, env=env, cwd=ROOT)


def _train(*argv):
    """``python -m repro_torch.launch.train`` without JAX."""
    code = ("import runpy, sys; sys.modules.update(jax=None, jaxlib=None, repro=None); "
            "sys.argv = ['train'] + sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.train', run_name='__main__')")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)


def test_mixed_precision_example_smoke():
    r = _run("torch_mixed_precision.py", "--frames", "2", "--patches", "16", "--device", "cpu")
    assert r.returncode == 0, f"example failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr}"
    assert "per-site bit map" in r.stdout
    assert re.search(r"plan beats w4a4: (True|False)", r.stdout)
    bytes_ = re.search(r"modeled weight bytes: plan=(\d+) uniform-w4a4=(\d+)", r.stdout)
    assert bytes_ and bytes_[1] == bytes_[2]
    for tier in ("quality", "balanced", "fast"):
        assert f"tier {tier}" in r.stdout


def test_observe_serving_example_smoke():
    r = _run("torch_observe_serving.py", "--requests", "3", "--prompt-len", "12", "--gen", "4",
             "--device", "cpu")
    assert r.returncode == 0, f"example failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr}"
    assert "scraped /metrics" in r.stdout
    assert "kernel_launches_total" in r.stdout
    assert "chain=enqueue -> admit -> prefill -> decode -> complete" in r.stdout
    assert "observability tour OK" in r.stdout


def test_quickstart_example_smoke():
    r = _run("torch_quickstart.py", "--steps", "2", "--device", "cpu")
    assert r.returncode == 0, f"example failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr}"
    assert "trained 2 steps, loss" in r.stdout
    assert "invariance rel err (16-bit 'lossless')" in r.stdout
    assert "W4A8 greedy-token agreement with fp" in r.stdout
    for method in ("rtn", "quarot", "versaq"):
        assert re.search(rf"W4A4 {method} +logits rel err: \d", r.stdout), method


def test_train_lm_example_smoke(tmp_path):
    """One run; resuming is held by ``test_train_launcher_then_resume`` (the
    same ``Trainer``) and ``tests/test_torch_train.py``."""
    r = _run("torch_train_lm.py", "--steps", "3", "--ckpt", str(tmp_path / "ckpt"),
             "--device", "cpu")
    assert r.returncode == 0, f"example failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr}"
    assert "done. final loss" in r.stdout and "[resume]" not in r.stdout
    assert (tmp_path / "ckpt" / "step_000000003" / "manifest.json").exists()


def test_serve_lm_example_smoke():
    r = _run("torch_serve_lm.py", "--steps", "2", "--requests", "3", "--prompt-len", "12",
             "--gen", "4", "--device", "cpu")
    assert r.returncode == 0, f"example failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr}"
    assert "greedy agreement" in r.stdout
    assert "per-bucket stats" in r.stdout


def test_serve_vggt_example_smoke():
    r = _run("torch_serve_vggt.py", "--steps", "2", "--frames", "2", "--patches", "16",
             "--requests", "1", "--device", "cpu")
    assert r.returncode == 0, f"example failed:\nSTDOUT:{r.stdout}\nSTDERR:{r.stderr}"
    assert "quant-vs-fp rel err" in r.stdout
    assert "per-bucket stats" in r.stdout


def test_train_launcher_then_resume(tmp_path):
    """Train with checkpoints; a second run with more ``--steps`` resumes
    from the first's last checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    common = ("--arch", "qwen3-14b-smoke", "--batch", "2", "--seq", "16", "--ckpt", ckpt,
              "--checkpoint-every", "2", "--device", "cpu")
    r = _train("--steps", "4", *common)
    assert r.returncode == 0, r.stderr
    assert "final loss:" in r.stdout and "[resume]" not in r.stdout
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_000000002", "step_000000004"]
    r = _train("--steps", "6", *common)
    assert r.returncode == 0, r.stderr
    assert "[resume] continuing from step 4" in r.stdout
    assert "final loss:" in r.stdout and "step     0 loss" not in r.stdout
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir())[-1] == "step_000000006"


def test_examples_need_a_card_unless_told_otherwise(tmp_path):
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run("torch_observe_serving.py", "--requests", "1")
    assert r.returncode != 0 and "no CUDA device is available" in r.stderr
    r = _train("--steps", "1", "--ckpt", str(tmp_path))  # the Trainer's own check
    assert r.returncode != 0 and "no CUDA device is available" in r.stderr
    r = _run("torch_long_context.py")
    assert r.returncode != 0 and "no CUDA device is available" in r.stderr
