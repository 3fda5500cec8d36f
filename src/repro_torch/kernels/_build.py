"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<name>-<hash>.so

The hash covers the source, every header in ``csrc/`` and the flags, so a
changed source rebuilds and an unchanged one loads the existing library.
``--use_fast_math`` is deliberately absent: ``__expf`` rounds differently
and would flip the two-stage kernel's int8 probabilities.  The ptxas report
(registers, shared memory, spills) is kept beside each library as
``<name>-<hash>.log``.

Builds never run at import time — only when a kernel is first launched,
or when :func:`build_all` is called, which starts one nvcc per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quant_matmul", "two_stage_attention", "fused_matmul", "fused_ffn", "norm_quant", "wht")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together.  Returns ``{name: {"path", "seconds",
    "ptxas"}}``; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "ptxas": _read_log(out)}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out, tmp)
    failed = []
    for name, (proc, out, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
        report[name] = {"path": str(out), "seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _read_log(lib: Path) -> str:
    log = lib.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed.  Cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
