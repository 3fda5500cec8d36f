"""The PyTorch port stands alone: importing every ``repro_torch`` module
loads neither JAX nor anything of the JAX package ``repro``, and no source
of the port (nor ``chip_smoke.py``) imports them."""
import pathlib
import re
import subprocess
import sys
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20  # every module of the port was imported
    assert bad == "[]", bad


def test_sources_import_no_jax_or_reference_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = {
        str(f.relative_to(ROOT)): _IMPORT.findall(f.read_text())
        for f in files
        if _IMPORT.search(f.read_text())
    }
    assert offenders == {}
