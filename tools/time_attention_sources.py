#!/usr/bin/env python3
"""Time the two-stage attention kernel against other versions of its source, on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python3 tools/time_attention_sources.py [NAME=PATH.cu ...] [--sass PATH]

Each ``NAME=PATH`` is a source with the C entry point
``vq_two_stage_attention`` of ``src/repro_torch/csrc/two_stage_attention.cu``
(an earlier version unpacked from git, or a design variant).  The committed
source and every other one are built with the port's own nvcc flags into
``build/attention_sources/``, one nvcc each, all at once.  For each source
it prints its ptxas resources, its worst error against the plain version and
how many int8 probabilities differ from the plain version's on one head, at
the frame (B=16, H=16, L=1029) and global (B=2, H=16, L=8232) shapes of a
vggt-1b forward (dh 64), then the CUDA-event time (L2 flushed) of each shape
in four passes, alternating the order of the sources, beside bf16 SDPA on
the same inputs.  ``--sass PATH`` writes the committed source's SASS there.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_sources"
# (label, B, H, L): the two attention shapes of a vggt-1b forward of 2 scenes x 8 frames
SHAPES = [("frame", 16, 16, 1029), ("global", 2, 16, 8232)]
DH = 64
PASSES = 4


def build(sources: dict[str, Path]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Each source's loaded library and the ptxas lines of its build."""
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc_path

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()
    }
    built = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        ptxas = " | ".join(line.split(":", 1)[-1].strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line)
        built[name] = (ctypes.CDLL(str(OUT / f"{name}.so")), ptxas)
    return built


def launcher(torch, lib: ctypes.CDLL):
    """``attention(qv, qs, kv, ks, vv, v_scale)`` through this library's
    kernel, for equal query and K/V heads and no causal mask."""
    fn = lib.vq_two_stage_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int

    def attention(qv, qs, kv, ks, vv, v_scale):
        bh, lq, dh = qv.shape
        out = torch.empty((bh, lq, dh), dtype=torch.float32, device=qv.device)
        rc = fn(qv.data_ptr(), qs.data_ptr(), kv.data_ptr(), ks.data_ptr(), vv.data_ptr(),
                v_scale.data_ptr(), out.data_ptr(), bh, lq, kv.shape[1], dh, 1, 1, 0,
                1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {rc}")
        return out

    return attention


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH")
    ap.add_argument("--sass", metavar="PATH")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_attention_sources: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import two_stage_attention as tsa
    from repro_torch.kernels.measure import attention_inputs, pq_flips, time_ms

    sources = {"committed": _build.CSRC / "two_stage_attention.cu"}
    for item in args.sources:
        name, path = item.split("=", 1)
        sources[name] = Path(path).resolve()
    built = build(sources)
    if args.sass:
        cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
        Path(args.sass).write_text(subprocess.run(
            [str(cuobjdump), "-sass", str(OUT / "committed.so")], capture_output=True, text=True,
            check=True).stdout)
    kernels = {name: launcher(torch, lib) for name, (lib, _) in built.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, b, h, length in SHAPES:
        a, _, vscale = attention_inputs(lambda *s: torch.randn(s, generator=gen, device=dev),
                                        b, h, h, length, DH)
        want = tsa.two_stage_attention_plain(*a)
        for name, attention in kernels.items():
            err = (attention(*a) - want).abs().max().item()
            flips, n = pq_flips(a, attention)
            print(f"{label} {name}: ptxas {built[name][1]}; max |err| vs plain {err:.3g}; "
                  f"pq flips {flips} of {n}")
        del want
        times = {name: [] for name in kernels}
        for i in range(PASSES):
            for name in list(kernels) if i % 2 == 0 else reversed(list(kernels)):
                times[name].append(time_ms(lambda: kernels[name](*a)))
        qf = (a[0].float() * a[1]).to(torch.bfloat16).view(b, h, length, DH)
        kf = (a[2].float() * a[3]).to(torch.bfloat16).view(b, h, length, DH)
        vf = (a[4].float() * vscale).to(torch.bfloat16).view(b, h, length, DH)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf))
        print(f"{label} (B={b} H={h} L={length} dh={DH}) ms per pass: "
              + ", ".join(f"{n} {'/'.join(f'{t:.4f}' for t in ts)}" for n, ts in times.items())
              + f"; bf16 SDPA {sdpa:.4f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
