"""The generated 64-point IDCT (``src/repro_torch/csrc/idct64.cuh``) on the
CPU: the header is what ``tools/gen_idct64.py`` writes, and its statements,
evaluated in float64 and in float32, give the block IDCT of
``core/transforms.py::dct_matrix``."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import transforms

ROOT = Path(__file__).resolve().parents[1]


def _gen():
    spec = importlib.util.spec_from_file_location("gen_idct64", ROOT / "tools" / "gen_idct64.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, v: np.ndarray) -> np.ndarray:
    """Evaluate the generated function `name` on the columns of v [rows, 32]."""
    text = (ROOT / "src" / "repro_torch" / "csrc" / "idct64.cuh").read_text()
    body = text.split(f"void {name}(float (&v)[32]) {{")[1].split("\n}")[0]
    dt = v.dtype.type
    env = {"v": [v[:, i] for i in range(32)], "fmaf": lambda a, b, c: a * b + c}
    for line in body.strip().splitlines():
        line = re.sub(r"(\d\.?\d*(?:e[-+]?\d+)?)f\b", r"dt(\1)", line.strip().rstrip(";"))
        if line.startswith("const float "):
            lhs, rhs = line[len("const float "):].split(" = ", 1)
            env[lhs] = eval(rhs, {"dt": dt}, env).astype(v.dtype)
        else:
            lhs, rhs = line.split(" = ", 1)
            env["v"][int(lhs[2:-1])] = eval(rhs, {"dt": dt}, env)
    return np.stack(env["v"], axis=1)


def _idct(x: np.ndarray) -> np.ndarray:
    e = _run("idct64_even", x[:, 0::2])
    o = _run("idct64_odd", x[:, 1::2])
    return np.concatenate([e + o, (e - o)[:, ::-1]], axis=1)


def test_header_is_generated():
    assert _gen().main(["--check"]) == 0


# float64 evaluation is bounded by the float32 constants (~1e-7 relative);
# a wrong factorization would be off by O(1)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 5e-7), (np.float32, 1e-6)])
def test_generated_idct_matches_dense(dtype, tol):
    x = np.random.default_rng(0).normal(size=(256, 64)).astype(dtype) * 3
    want = x.astype(np.float64) @ transforms.dct_matrix(64).double().numpy()
    got = _idct(x).astype(np.float64)
    err = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert err.max() < tol, err.max()
