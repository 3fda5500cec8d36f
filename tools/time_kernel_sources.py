#!/usr/bin/env python3
"""Time a kernel of the port against other versions of its source, on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python3 tools/time_kernel_sources.py [--kernel KERNEL] [NAME=PATH.cu ...]
        [--sass PATH] [--split]

``--kernel`` is ``two_stage_attention`` (the default), ``fused_ffn``,
``fused_matmul``, ``quant_matmul``, ``norm_quant`` or ``wht``.  Each
``NAME=PATH`` is a source with the same C entry point as
``src/repro_torch/csrc/<kernel>.cu`` (an earlier version unpacked from git,
or a design variant written under ``build/``, such as one with a phase
taken out).  A source's ``#include "..."`` resolves beside it
first, so an earlier version unpacked with its own headers builds against
them.  The committed source and every other one are built with the port's
own nvcc flags into ``build/kernel_sources/``, one nvcc each, all at once.
For each source it prints its ptxas resources (and its ``vq_<kernel>_attrs``
reading where the source has that entry), its error against the plain
version at each shape of the kernel's table, then the CUDA-event time (L2
flushed) of each shape in four passes, alternating the order of the
sources.

* two_stage_attention: the frame (B=16, H=16, L=1029) and global (B=2,
  H=16, L=8232) shapes of a vggt-1b forward (dh 64), how many int8
  probabilities differ from the plain version's on one head, and bf16 SDPA
  on the same inputs.
* fused_ffn: the served FFN of vggt-1b (M = 2 x 8 x 1029 = 16464, D=1024,
  d_ff=4096, packed W4, A8, ln, tanh-GELU, hidden WHT 4096, IDCT on both,
  biases); each source is also timed with the two IDCT flags off (a launch
  argument: a timing, not the same function).  A source without
  ``vq_fused_ffn_attrs`` is taken to have the earlier entry point (``git
  show 5aeb387:src/repro_torch/csrc/fused_ffn.cu``), which also takes a
  row-scale scratch and the 64-point DCT matrix.
* fused_matmul: the served projections of the fused plan, M = 16464,
  packed W4, A8, IDCT, bias: wqkv (K=1024, N=3072, ln prologue) and wo
  (K=1024, N=1024, no norm).  A source without ``vq_fused_matmul_attrs`` is
  taken to have the earlier entry point (``git show
  bb9b1b2:src/repro_torch/csrc/fused_matmul.cu``), which also takes the
  64-point DCT matrix and a row-scale scratch.  ``--split`` times three
  more calls of each source, each through its launch arguments: the IDCT
  off, a pre-quantized input (the same int8 values and scales, so no
  prologue), and both; then prints the prologue (served less
  pre-quantized), the IDCT (served less IDCT off) and the matmul with its
  scaling and store (both off) of each source, in ms and as shares.

* quant_matmul: the unfused plan's W4A8 projections of vggt-1b, M =
  16464: wq (K=1024, N=1024, also wk, wv and wo), w_up (1024 x 4096) and
  w_down (4096 x 1024), and the W8 check (1024 x 4096, int8 weights);
  each source's maximum error against the plain version (0: the integer
  sum is exact), and ``torch._int_mm`` with the scaling on the same
  inputs.  Every version of the source has the same entry point.

* norm_quant and wht: the prologue phase's shapes, M = 16464 rows:
  ``norm_quant`` at D=1024 (ln, WHT block 1024, A8) and ``wht`` at d=4096
  (block 4096, the FFN hidden's shape).  For each source: its maximum
  difference from the committed kernel's output on the same inputs (int8
  values and scales for ``norm_quant``: 0 where the two are bit-identical)
  and from the plain version, and per pass its time, its rate in TB/s (the
  bytes the function must move: each input read once, each output written
  once) and its ratio to that byte bound at 3.35 TB/s.  Every version has
  the same entry point; one without ``vq_<kernel>_blocks_per_sm`` gets the
  earlier wrappers' grid (8 rows a block, at most 8 blocks an SM).

``--sass PATH`` writes the committed source's SASS there.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_sources"
KERNELS = ("two_stage_attention", "fused_ffn", "fused_matmul", "quant_matmul", "norm_quant", "wht")
S_FRAMES, N_PATCHES, N_SPECIAL, BATCH = 8, 1024, 5, 2
TOKENS = BATCH * S_FRAMES * (N_SPECIAL + N_PATCHES)
# shapes of a vggt-1b forward of 2 scenes x 8 frames
SHAPES = {
    # (label, B, H, L), head dim DH
    "two_stage_attention": [("frame", BATCH * S_FRAMES, 16, N_SPECIAL + N_PATCHES),
                            ("global", BATCH, 16, S_FRAMES * (N_SPECIAL + N_PATCHES))],
    # (label, M, D, d_ff)
    "fused_ffn": [("served", TOKENS, 1024, 4096)],
    # (label, M, K, N, prologue norm)
    "fused_matmul": [("wqkv", TOKENS, 1024, 3072, "ln"), ("wo", TOKENS, 1024, 1024, None)],
    # (label, M, K, N, weight bits)
    "quant_matmul": [("wq", TOKENS, 1024, 1024, 4), ("w_up", TOKENS, 1024, 4096, 4),
                     ("w_down", TOKENS, 4096, 1024, 4), ("w8 check", TOKENS, 1024, 4096, 8)],
    # (label, M, D, norm, WHT block, bits)
    "norm_quant": [("served", TOKENS, 1024, "ln", 1024, 8)],
    # (label, R, d, block)
    "wht": [("ffn hidden", TOKENS, 4096, 4096)],
}
# the launch-argument split of fused_matmul: (variant, IDCT on, pre-quantized input)
SPLIT = [("served", True, False), ("idct off", False, False), ("prequant", True, True),
         ("both off", False, True)]
DH = 64
PASSES = 4
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
_NORMS = {None: 0, "rms": 1, "ln": 2}
_ACTS = {"none": 0, "gelu": 1, "silu": 2}


def parse_args(argv=None) -> argparse.Namespace:
    """The options, with ``sources`` as an ordered {name: Path}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, default="two_stage_attention")
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH")
    ap.add_argument("--sass", metavar="PATH")
    ap.add_argument("--split", action="store_true",
                    help="fused_matmul: also time the IDCT off, a pre-quantized input, and both")
    args = ap.parse_args(argv)
    if args.split and args.kernel != "fused_matmul":
        ap.error("--split is an option of --kernel fused_matmul")
    sources = {}
    for item in args.sources:
        name, sep, path = item.partition("=")
        if not sep or not name or not path or name == "committed" or name in sources:
            ap.error(f"bad source {item!r}: want NAME=PATH with a new NAME other than 'committed'")
        sources[name] = Path(path).resolve()
    args.sources = sources
    return args


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


def _passes(kernels: dict, run) -> dict[str, list[float]]:
    """``run(name)``'s time for each source over PASSES passes, the order of
    the sources reversed on every other pass."""
    times = {name: [] for name in kernels}
    for i in range(PASSES):
        for name in list(kernels) if i % 2 == 0 else reversed(list(kernels)):
            times[name].append(run(name))
    return times


def _rel_l2(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


@functools.lru_cache(maxsize=None)
def _dct(torch, dev):
    """The 64-point DCT matrix an earlier entry point reads, made once per
    device (its wrapper cached it too), so no upload lands in a timing."""
    from repro_torch.core import transforms

    return transforms.dct_matrix(64, device=dev).contiguous()


def _fmt(times: dict[str, list[float]]) -> str:
    return ", ".join(f"{n} {'/'.join(f'{t:.4f}' for t in ts)}" for n, ts in times.items())


def attention_launcher(torch, lib: ctypes.CDLL):
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


def time_attention(torch, built) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import two_stage_attention as tsa
    from repro_torch.kernels.measure import attention_inputs, kernel_attrs, pq_flips, time_ms

    kernels = {name: attention_launcher(torch, lib) for name, (lib, _) in built.items()}
    for name, (lib, _) in built.items():
        if hasattr(lib, "vq_two_stage_attention_attrs"):
            print(f"{name}: attrs {kernel_attrs(lib, 'two_stage_attention', DH, DH ** -0.5)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, b, h, length in SHAPES["two_stage_attention"]:
        a, _, vscale = attention_inputs(lambda *s: torch.randn(s, generator=gen, device=dev),
                                        b, h, h, length, DH)
        want = tsa.two_stage_attention_plain(*a)
        for name, attention in kernels.items():
            err = (attention(*a) - want).abs().max().item()
            flips, n = pq_flips(a, attention)
            print(f"{label} {name}: ptxas {built[name][1]}; max |err| vs plain {err:.3g}; "
                  f"pq flips {flips} of {n}")
        del want
        times = _passes(kernels, lambda name: time_ms(lambda: kernels[name](*a)))
        qf = (a[0].float() * a[1]).to(torch.bfloat16).view(b, h, length, DH)
        kf = (a[2].float() * a[3]).to(torch.bfloat16).view(b, h, length, DH)
        vf = (a[4].float() * vscale).to(torch.bfloat16).view(b, h, length, DH)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf))
        print(f"{label} (B={b} H={h} L={length} dh={DH}) ms per pass: {_fmt(times)}; "
              f"bf16 SDPA {sdpa:.4f}")


def ffn_argtypes(earlier: bool) -> list:
    """ctypes argument types of ``vq_fused_ffn``: the present entry point, or
    the earlier one (commit 5aeb387), which takes the DCT matrix after the
    packing flags and the row-scale scratch ``ss`` after ``sq``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return ([p, p, f, i, i, i] + [p] * 9 + [i] * 3 + [p] * earlier + [i] * 5
            + [p] * (3 + earlier) + [i] * 5 + [p])


def ffn_launcher(torch, lib: ctypes.CDLL):
    """``ffn(*args, **kw)`` through this library's kernel, for a call of
    ``measure.ffn_inputs``, with the grid and scratch the port's wrapper
    gives it."""
    earlier = not hasattr(lib, "vq_fused_ffn_attrs")
    fn = lib.vq_fused_ffn
    fn.argtypes = ffn_argtypes(earlier)
    fn.restype = ctypes.c_int
    per_sm = lib.vq_fused_ffn_blocks_per_sm
    per_sm.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    per_sm.restype = ctypes.c_int

    @functools.lru_cache(maxsize=None)
    def blocks(d, dff, idct):
        b = ctypes.c_int(0)
        if per_sm(d, dff, idct, ctypes.byref(b)) != 0:
            raise RuntimeError("no block fits on an SM")
        return b.value

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ffn(x, wu, wus, wd, wds, wg, wgs, bg, bu, bd, u, *, packed_g, packed_u, packed_d,
            a_bits_in, a_bits_mid, norm_kind, act, pro_wht_block, mid_wht_block, idct_h,
            idct_out, dct_block):
        dev = x.device
        (m, d), dff, n_out = x.shape, wu.shape[1], wd.shape[1]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(-(-m // 64), blocks(d, dff, int(idct_h or idct_out)) * sms))
        out = torch.empty((m, n_out), dtype=torch.float32, device=dev)
        sq = torch.empty(grid * 64 * max(d, dff), dtype=torch.int8, device=dev)
        sh = torch.empty(grid * 64 * dff, dtype=torch.float32, device=dev)
        head = [x.data_ptr(), ptr(u), 1e-6, _NORMS[norm_kind], pro_wht_block or 0, a_bits_in,
                ptr(wg), ptr(wgs), ptr(bg), wu.data_ptr(), wus.data_ptr(), ptr(bu),
                wd.data_ptr(), wds.data_ptr(), ptr(bd), int(packed_g), int(packed_u),
                int(packed_d)]
        flags = [int(idct_h), int(idct_out), _ACTS[act], mid_wht_block or 0, a_bits_mid]
        tail = [m, d, dff, n_out, grid, torch.cuda.current_stream().cuda_stream]
        if earlier:
            ss = torch.empty(grid * 2 * 64, dtype=torch.float32, device=dev)
            rc = fn(*head, _dct(torch, dev).data_ptr(), *flags, out.data_ptr(), sq.data_ptr(),
                    ss.data_ptr(), sh.data_ptr(), *tail)
        else:
            rc = fn(*head, *flags, out.data_ptr(), sq.data_ptr(), sh.data_ptr(), *tail)
        if rc != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {rc}")
        return out

    return ffn


def time_ffn(torch, built) -> None:
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import ffn_inputs, kernel_attrs, time_ms

    dev = torch.device("cuda")
    runs = {name: ffn_launcher(torch, lib) for name, (lib, _) in built.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, m, d, dff in SHAPES["fused_ffn"]:
        args, kw = ffn_inputs(lambda *s: torch.randn(s, generator=gen, device=dev), m, d, dff)
        no_idct = {**kw, "idct_h": False, "idct_out": False, "dct_block": None}
        want = fz.fused_ffn_plain(*args, **kw)
        for name, (lib, ptxas) in built.items():
            got = runs[name](*args, **kw)
            torch.cuda.synchronize()
            rel = _rel_l2(got, want)
            attrs = (kernel_attrs(lib, "fused_ffn", d, dff, 1)
                     if hasattr(lib, "vq_fused_ffn_attrs") else "n/a")
            print(f"{label} {name}: ptxas {ptxas}; attrs {attrs}; rel L2 vs plain {rel:.3g}; "
                  f"max |err| {(got - want).abs().max().item():.3g}")
        del want, got
        times = _passes(built, lambda name: time_ms(lambda: runs[name](*args, **kw)))
        print(f"{label} (M={m} D={d} d_ff={dff}) ms per pass: {_fmt(times)}")
        times = _passes(built, lambda name: time_ms(lambda: runs[name](*args, **no_idct)))
        print(f"{label} IDCT flags off, ms per pass: {_fmt(times)}")


def fm_argtypes(earlier: bool) -> list:
    """ctypes argument types of ``vq_fused_matmul``: the present entry point,
    or the earlier one (commit bb9b1b2), which takes the DCT matrix after
    the bias and the row-scale scratch ``ss`` after ``sq``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return ([p, p, p, p, f, i, i, i, p, p, i, p] + [p] * earlier + [i] * 4 + [p] * 4
            + [p] * earlier + [p] + [i] * 4 + [p])


def fm_launcher(torch, lib: ctypes.CDLL):
    """``fm(x, wv, ws, xs, bias, u, **kw)`` through this library's kernel, for
    a call of ``measure.fused_matmul_inputs`` (f32 output, no activation,
    WHT or requantization), with the grid and scratch the port's wrapper
    gives it.  ``xs`` given: ``x`` is the pre-quantized int8 input."""
    earlier = not hasattr(lib, "vq_fused_matmul_attrs")
    fn = lib.vq_fused_matmul
    fn.argtypes = fm_argtypes(earlier)
    fn.restype = ctypes.c_int
    per_sm = lib.vq_fused_matmul_blocks_per_sm
    per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    per_sm.restype = ctypes.c_int

    @functools.lru_cache(maxsize=None)
    def blocks(n, k, flag):  # flag: the IDCT (earlier), a pre-quantized input (present)
        b = ctypes.c_int(0)
        if per_sm(n, k, 0, flag, ctypes.byref(b)) != 0:
            raise RuntimeError("no block fits on an SM")
        return b.value

    def ptr(t):
        return None if t is None else t.data_ptr()

    def fm(x, wv, ws, xs, bias, u, *, packed, a_bits, norm_kind, dct_block):
        dev = x.device
        (m, k), n = x.shape, wv.shape[1]
        preq, idct = xs is not None, dct_block is not None
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(-(-m // 64), blocks(n, k, int(idct if earlier else preq)) * sms))
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        sq = torch.empty(grid * 64 * k, dtype=torch.int8, device=dev)
        head = [None if preq else x.data_ptr(), x.data_ptr() if preq else None, ptr(xs), ptr(u),
                1e-6, 0 if preq else _NORMS[norm_kind], 0, a_bits, wv.data_ptr(), ws.data_ptr(),
                int(packed), ptr(bias)]
        flags = [int(idct), _ACTS["none"], 0, 0, out.data_ptr(), None, None, sq.data_ptr()]
        tail = [None, m, n, k, grid, torch.cuda.current_stream().cuda_stream]
        if earlier:
            ss = torch.empty(grid * 64, dtype=torch.float32, device=dev)
            dct = _dct(torch, dev).data_ptr() if idct else None
            rc = fn(*head, dct, *flags, ss.data_ptr(), *tail)
        else:
            rc = fn(*head, *flags, *tail)
        if rc != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {rc}")
        return out

    return fm


def time_fused_matmul(torch, built, split: bool) -> None:
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import fused_matmul_inputs, kernel_attrs, time_ms

    dev = torch.device("cuda")
    runs = {name: fm_launcher(torch, lib) for name, (lib, _) in built.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, m, k, n, norm in SHAPES["fused_matmul"]:
        args, kw = fused_matmul_inputs(lambda *s: torch.randn(s, generator=gen, device=dev), m, k,
                                       n, norm=norm)
        xq, xs = fz.norm_quant_plain(args[0], args[5], norm_kind=norm, a_bits=kw["a_bits"])
        pre = (xq, *args[1:3], xs, args[4], None)
        calls = {v: (pre if preq else args,
                     {**kw, "dct_block": 64 if idct else None,
                      "norm_kind": None if preq else norm})
                 for v, idct, preq in (SPLIT if split else SPLIT[:1])}
        for variant, (a, vkw) in calls.items():
            want = fz.fused_matmul_plain(*a, **vkw)
            for name, (lib, ptxas) in built.items():
                got = runs[name](*a, **vkw)
                torch.cuda.synchronize()
                attrs = (kernel_attrs(lib, "fused_matmul", n, k, 0, int(a is pre))
                         if hasattr(lib, "vq_fused_matmul_attrs") else "n/a")
                print(f"{label} {variant} {name}: ptxas {ptxas}; attrs {attrs}; rel L2 vs plain "
                      f"{_rel_l2(got, want):.3g}; max |err| {(got - want).abs().max().item():.3g}")
            del want, got
        keys = [f"{name}:{v}" for name in built for v in calls]

        def run(key):
            name, variant = key.split(":")
            a, vkw = calls[variant]
            return time_ms(lambda: runs[name](*a, **vkw))

        times = _passes(keys, run)
        print(f"{label} (M={m} K={k} N={n}) ms per pass: {_fmt(times)}")
        if split:
            for name in built:
                med = {v: statistics.median(times[f"{name}:{v}"]) for v in calls}
                parts = {"prologue": med["served"] - med["prequant"],
                         "IDCT": med["served"] - med["idct off"],
                         "matmul+store": med["both off"]}
                parts["rest"] = med["served"] - sum(parts.values())
                print(f"{label} {name} split of {med['served']:.4f} ms: " + ", ".join(
                    f"{p} {t:.4f} ({100 * t / med['served']:.1f}%)" for p, t in parts.items()))


def qm_launcher(torch, lib: ctypes.CDLL):
    """``qm(xv, xs, wv, ws, packed)`` through this library's kernel."""
    fn = lib.vq_quant_matmul
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int

    def qm(xv, xs, wv, ws, packed):
        (m, k), n = xv.shape, wv.shape[1]
        out = torch.empty((m, n), dtype=torch.float32, device=xv.device)
        rc = fn(xv.data_ptr(), xs.data_ptr(), wv.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n,
                k, int(packed), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {rc}")
        return out

    return qm


def time_quant_matmul(torch, built) -> None:
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qmk
    from repro_torch.kernels.measure import kernel_attrs, time_ms

    dev = torch.device("cuda")
    runs = {name: qm_launcher(torch, lib) for name, (lib, _) in built.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, m, k, n, bits in SHAPES["quant_matmul"]:
        xq = quantize_per_token(torch.randn((m, k), generator=gen, device=dev), 8)
        wq = quantize_weight(torch.randn((k, n), generator=gen, device=dev), bits)
        a = (xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1).contiguous(), wq.packed)
        want = qmk.quant_matmul_plain(*a[:4], packed=wq.packed)
        for name, (lib, ptxas) in built.items():
            got = runs[name](*a)
            torch.cuda.synchronize()
            attrs = (kernel_attrs(lib, "quant_matmul", n, k, int(wq.packed))
                     if hasattr(lib, "vq_quant_matmul_attrs") else "n/a")
            print(f"{label} {name}: ptxas {ptxas}; attrs {attrs}; max |err| vs plain "
                  f"{(got - want).abs().max().item():.3g}")
        del want, got
        times = _passes(runs, lambda name: time_ms(lambda: runs[name](*a)))
        w_cm = (unpack_int4(wq.values, 0) if wq.packed else wq.values).t().contiguous().t()
        lib_ms = time_ms(lambda: torch._int_mm(a[0], w_cm).float() * a[1] * a[3])
        print(f"{label} (M={m} K={k} N={n} W{bits}A8) ms per pass: {_fmt(times)}; "
              f"torch._int_mm + scaling {lib_ms:.4f}")


def row_argtypes(kernel: str) -> list:
    """ctypes argument types of ``vq_wht`` or ``vq_norm_quant``, the same in
    every version of the two sources."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return {"wht": [p, p, i, i, i, i, p], "norm_quant": [p, p, f, i, i, i, p, p, i, i, i, p]}[kernel]


def row_launcher(torch, lib: ctypes.CDLL, kernel: str):
    """``run(x, *rest)`` through this library's row kernel: ``wht(x,
    block)`` -> y, ``norm_quant(x, u, norm, block, bits)`` -> (q, s), with
    the grid its wrapper gives it."""
    from repro_torch.kernels.fused import ROW_WARPS

    fn = getattr(lib, f"vq_{kernel}")
    fn.argtypes = row_argtypes(kernel)
    fn.restype = ctypes.c_int
    per_sm = getattr(lib, f"vq_{kernel}_blocks_per_sm", None)
    if per_sm is not None:
        per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        per_sm.restype = ctypes.c_int

    @functools.lru_cache(maxsize=None)
    def grid(rows, width):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if per_sm is None:  # the earlier wrappers: 8 rows a block, 8 blocks an SM
            return max(1, min(-(-rows // 8), 8 * sms))
        b = ctypes.c_int(0)
        if per_sm(width, ctypes.byref(b)) != 0 or b.value < 1:
            raise RuntimeError("no block fits on an SM")
        return max(1, min(-(-rows // ROW_WARPS), b.value * sms))

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {rc}")

    def run_wht(x, block):
        (r, d), y = x.shape, torch.empty_like(x)
        check(fn(x.data_ptr(), y.data_ptr(), r, d, block, grid(r, d),
                 torch.cuda.current_stream().cuda_stream))
        return y

    def run_norm_quant(x, u, norm, block, bits):
        m, d = x.shape
        q = torch.empty((m, d), dtype=torch.int8, device=x.device)
        s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
        check(fn(x.data_ptr(), None if u is None else u.data_ptr(), 1e-6, _NORMS[norm], block,
                 bits, q.data_ptr(), s.data_ptr(), m, d, grid(m, d),
                 torch.cuda.current_stream().cuda_stream))
        return q, s

    return run_wht if kernel == "wht" else run_norm_quant


def _max_diff(got, want) -> float:
    """Largest |difference| over a tensor or over each of a tuple's."""
    if isinstance(got, tuple):
        return max(_max_diff(g, w) for g, w in zip(got, want))
    return (got.double() - want.double()).abs().max().item()


def time_rows(torch, built, kernel: str) -> None:
    from repro_torch.core.versaq import make_folded_norm
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels import wht as whtk
    from repro_torch.kernels.measure import kernel_attrs, time_ms

    dev = torch.device("cuda")
    runs = {name: row_launcher(torch, lib, kernel) for name, (lib, _) in built.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, m, d, *rest in SHAPES[kernel]:
        x = torch.randn((m, d), generator=gen, device=dev)
        if kernel == "wht":
            (block,) = rest
            a = (x, block)
            want = whtk.wht_plain(x, block=block)
            nbytes = 8.0 * m * d
            shape = f"R={m} d={d} block={block}"
        else:
            norm, block, bits = rest
            u = make_folded_norm("ln", d, device=dev).u if norm == "ln" else None
            a = (x, u, norm, block, bits)
            want = fz.norm_quant_plain(x, u, norm_kind=norm, wht_block=block, a_bits=bits)
            nbytes = 5.0 * m * d + 4 * m + (4 * d if u is not None else 0)
            shape = f"M={m} D={d} norm={norm} block={block} A{bits}"
        outs = {name: run(*a) for name, run in runs.items()}
        torch.cuda.synchronize()
        for name, (lib, ptxas) in built.items():
            attrs = (kernel_attrs(lib, kernel, d) if hasattr(lib, f"vq_{kernel}_attrs") else "n/a")
            print(f"{label} {name}: ptxas {ptxas}; attrs {attrs}; max |diff| vs committed "
                  f"{_max_diff(outs[name], outs['committed']):.3g}; vs plain "
                  f"{_max_diff(outs[name], want):.3g}")
        del outs, want
        times = _passes(runs, lambda name: time_ms(lambda: runs[name](*a)))
        bound = nbytes / PEAK_BYTES * 1e3
        print(f"{label} ({shape}) ms per pass: {_fmt(times)}; byte bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB)")
        for name, ts in times.items():
            print(f"{label} {name}: TB/s per pass "
                  + "/".join(f"{nbytes / t / 1e9:.3f}" for t in ts)
                  + "; x bound per pass " + "/".join(f"{t / bound:.2f}" for t in ts))


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_kernel_sources: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    sources = {"committed": _build.CSRC / f"{args.kernel}.cu", **args.sources}
    built = build(sources)
    if args.sass:
        cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
        Path(args.sass).write_text(subprocess.run(
            [str(cuobjdump), "-sass", str(OUT / "committed.so")], capture_output=True, text=True,
            check=True).stdout)
    if args.kernel == "two_stage_attention":
        time_attention(torch, built)
    elif args.kernel == "fused_ffn":
        time_ffn(torch, built)
    elif args.kernel == "quant_matmul":
        time_quant_matmul(torch, built)
    elif args.kernel in ("norm_quant", "wht"):
        time_rows(torch, built, args.kernel)
    else:
        time_fused_matmul(torch, built, args.split)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
