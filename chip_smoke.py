#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of VersaQ-3D.

Run from the repository root on a machine with one NVIDIA GPU (written for
an H100) and the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and does, in order:

1. builds the six CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the served paths below give it (two scenes of S=8 frames x
   P=1024 patches per forward: M = 2 * 8 * 1029 = 16464 tokens), plus small
   cases (W8, A4, a requant epilogue, a pre-quantized input, a gated SiLU
   FFN, ragged M, causal and GQA attention); times kernel, plain version,
   the card's bound and, where one PyTorch call computes the same function,
   that call (``torch._int_mm``, ``F.scaled_dot_product_attention``,
   ``torch.matmul`` with the blocked Hadamard); for ``quant_matmul``, the
   two-stage kernel, ``fused_matmul`` and ``fused_ffn`` also their
   registers, shared memory per block, resident blocks per SM and spills
   (at the served widths), and how many of the two-stage kernel's int8
   probabilities differ from the plain version's (read back through a
   one-hot V);
3. runs vggt-1b width with 2 AA pairs once with the kernels and once with
   the plain versions, for the unfused W4A8 plan and for the fused one, and
   holds each block as in 5;
4. serves vggt-1b at full width and depth (24 AA pairs, random weights from
   seed 0) with the unfused plan ``PrecisionPlan(default="w4a8",
   use_kernel=True)``: 288 ``quant_matmul`` and 48 ``two_stage_attention``
   launches per forward;
5. serves the same model with the fused plan ``PrecisionPlan(default="w4a8",
   use_kernel=True, fuse=True)``: 96 ``fused_matmul``, 48 ``fused_ffn``, 48
   ``two_stage_attention`` and 0 ``quant_matmul`` launches per forward,
   finite outputs, the first micro-batch against a plain-version forward
   (rel L2 < 1e-3) and the served outputs against the unfused plan's on the
   same weights (rel L2 < 1e-2).  vggt-1b's LayerScale (1e-5) keeps each
   block's part of those outputs small, and a larger one (0.2) lets the
   random weights amplify last-bit differences to ~4e-2 on the pose at 2
   pairs (those of the unfused path, whose matmul is bit-exact), so the
   paths are also held block by block: every block's two residual branches
   (attention and FFN, what the block adds to the stream), fed the stream
   of that forward, against the plain versions (< 1e-3) and against the
   other plan's block (< 1e-2), which no LayerScale hides or amplifies;
6. drives ``ops.norm_quant_prologue`` into three pre-quantized
   ``ops.fused_linear`` launches sharing its output (Q/K/V), and
   ``ops.online_wht_2d`` on the FFN hidden's shape.

Each of the paths 4-6 runs with the launch counts set to 0 just before it
and read just after.  Both serve paths use 4 requests of one scene each,
``max_batch=2``, two-stage attention.  Any failed check raises, so the
script exits non-zero.  The kernels' JSON line carries, per kernel, its
launches on the path that ran it (``path``); ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are isolated timings (each distinct shape
timed once, L2 flushed) weighted by those launches, and ``inplace_ms`` is
the kernel's device time when that path's forwards are replayed under
``torch.profiler``.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Hopper H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor cores, f32
# on the CUDA cores, and HBM3 bandwidth; the special-function units give 16
# results per clock per SM: 132 SMs x 16 x 1.83 GHz.
PEAK_INT8_OPS = 1979e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 132 * 16 * 1.83e9

S_FRAMES, N_PATCHES, BATCH = 8, 1024, 2
# A fast 64-point DCT (Chen/Loeffler: N/2 log2 N multiplies and 3N/2
# log2 N adds, 192 + 576 per block) does 12 f32 operations per output: the
# least work of the fused kernels' block IDCT.  Both run a generated fast
# DCT-III (csrc/idct64.cuh) at ~10-12 operations an output.
IDCT_OPS = (64 // 2 * 6 + 3 * 64 // 2 * 6) / 64
KERNELS = ("quant_matmul", "two_stage_attention", "fused_matmul", "fused_ffn", "norm_quant",
           "wht")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(report)}")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kernels = phase_kernels(torch, dev)
    phase_model(torch, dev)
    unfused = phase_serve(torch, dev, fused=False)
    fused = phase_serve(torch, dev, fused=True, compare=unfused)
    paths = {"serve_unfused": unfused, "serve_fused": fused, "prologue": phase_prologue(torch, dev)}
    out = summarize(kernels, paths)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# the path whose launches each kernel's JSON record reports
HOME = {"quant_matmul": "serve_unfused", "two_stage_attention": "serve_fused",
        "fused_matmul": "serve_fused", "fused_ffn": "serve_fused", "norm_quant": "prologue",
        "wht": "prologue"}


def summarize(kernels: dict[str, dict], paths: dict[str, dict]) -> list[dict]:
    """Each kernel's record: launches on its home path (and on every path),
    timings weighted by that path's runs, in-place time from its profile."""
    out = []
    for name in KERNELS:
        k, path = kernels[name], paths[HOME[name]]
        k["path"] = HOME[name]
        k["launches"] = path["counts"].get(name, 0)
        k["launches_by_path"] = {p: v["counts"].get(name, 0) for p, v in paths.items()}
        _check(k["launches"] > 0, f"{name} was not launched on the {HOME[name]} path")
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None:
                k[key] *= path["runs"]  # forwards (or prologue passes) of that path
        k["timing"] = "isolated per-shape medians (L2 flushed) weighted by the path's launches"
        k["inplace_ms"] = path["inplace"].get(name)
        out.append(k)
    return out


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def _bound_ms(nbytes: float, int8_ops: float = 0.0, sfu: float = 0.0,
              f32_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth against each
    operation type over its own peak (they run on separate units)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(int8_ops / PEAK_INT8_OPS, sfu / PEAK_SFU, f32_ops / PEAK_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(torch, got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


def _q_flips(torch, got, want) -> int:
    """Entries of two int8 tensors that differ; raises if any differs by
    more than one step."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    _check(int(d.max()) <= 1, f"int8 outputs differ by {int(d.max())} steps")
    return int((d > 0).sum())


class _Entry:
    """One kernel's record: errors and per-forward weighted timings."""

    def __init__(self, name, source, replaces, library_note=None):
        self.d = dict(name=name, route="cuda", source=source, replaces=replaces,
                      max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      library_ms=None if library_note else 0.0)
        if library_note:
            self.d["library_note"] = library_note
        self._by = {}

    def add(self, err, nper, ms, plain, bound, by, lib=None):
        self.d["max_abs_err"] = max(self.d["max_abs_err"], err)
        if not nper:
            return
        self.d["ms"] += nper * ms
        self.d["plain_ms"] += nper * plain
        self.d["bound_ms"] += nper * bound
        if self.d["library_ms"] is not None:
            self.d["library_ms"] += nper * lib
        self._by[by] = self._by.get(by, 0.0) + nper * bound

    def done(self) -> dict:
        self.d["bound_by"] = max(self._by, key=self._by.get)
        return self.d


# ---------------------------------------------------------------------------
# phase 2: each kernel vs its plain version at the served shapes
# ---------------------------------------------------------------------------


def phase_kernels(torch, dev) -> dict[str, dict]:
    from repro_torch.configs import get_config

    cfg = get_config("vggt-1b")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    m = BATCH * S_FRAMES * (cfg.n_special_tokens + N_PATCHES)
    out = {}
    out["quant_matmul"] = _kernel_quant_matmul(torch, cfg, m, randn)
    out["two_stage_attention"] = _kernel_attention(torch, cfg, randn)
    out["fused_matmul"] = _kernel_fused_matmul(torch, dev, cfg, m, randn)
    out["fused_ffn"] = _kernel_fused_ffn(torch, dev, cfg, m, randn)
    out["norm_quant"] = _kernel_norm_quant(torch, dev, cfg, m, randn)
    out["wht"] = _kernel_wht(torch, dev, cfg, m, randn)
    return out


def _kernel_quant_matmul(torch, cfg, m, randn) -> dict:
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.measure import time_ms

    d, dff = cfg.d_model, cfg.d_ff
    # (label, K, N, w_bits, launches per AA pair and forward)
    cases = [("wq/wk/wv/wo", d, d, 4, 8), ("w_up", d, dff, 4, 2), ("w_down", dff, d, 4, 2),
             ("w8 check", d, dff, 8, 0)]
    e = _Entry("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
               "src/repro/kernels/quant_matmul.py:151")
    attrs, res = _attrs("quant_matmul", d, d, 1)  # the W4 instance, at wq's widths
    e.d.update(attrs)
    for label, k, n, bits, per_pair in cases:
        nper = per_pair * cfg.n_layers
        xq = quantize_per_token(randn(m, k), 8)
        wq = quantize_weight(randn(k, n), bits)
        ws = wq.scale.reshape(1, -1).contiguous()
        args = (xq.values, xq.scale, wq.values, ws)
        got = qm.quant_matmul(*args, packed=wq.packed)
        want = qm.quant_matmul_plain(*args, packed=wq.packed)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)  # integer part is exact
        del got, want
        ms = time_ms(lambda: qm.quant_matmul(*args, packed=wq.packed))
        plain = time_ms(lambda: qm.quant_matmul_plain(*args, packed=wq.packed), reps=3)
        w_cm = (unpack_int4(wq.values, 0) if wq.packed else wq.values).t().contiguous().t()
        lib = time_ms(lambda: torch._int_mm(xq.values, w_cm).float() * xq.scale * ws)
        nbytes = m * k + 4 * m + wq.values.numel() + 4 * n + 4 * m * n
        bound, by = _bound_ms(nbytes, 2.0 * m * k * n)
        print(f"quant_matmul {label:12s} M={m} K={k} N={n} W{bits}: err={err:.3g} "
              f"kernel={ms:.4f}ms plain={plain:.4f}ms int_mm={lib:.4f}ms bound={bound:.4f}ms "
              f"({by}) x{nper}/forward; {res}")
        e.add(err, nper, ms, plain, bound, by, lib)
    return e.done()


def _attrs(kernel: str, *args) -> tuple[dict, str]:
    """A kernel's resources from ``vq_<kernel>_attrs(*args)``, and their line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.measure import kernel_attrs

    a = kernel_attrs(_build.load(kernel), kernel, *args)
    return a, (f"regs={a['registers']} smem/block={a['smem_per_block']}B "
               f"blocks/SM={a['blocks_per_sm']} spill={a['spill_bytes']}B")


def _kernel_attention(torch, cfg, randn) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import two_stage_attention as tsa
    from repro_torch.kernels.measure import attention_inputs, pq_flips, time_ms

    h, dh = cfg.n_heads, cfg.head_dim
    t = cfg.n_special_tokens + N_PATCHES
    # (label, B, H, Hkv, L, causal, launches per forward of the fused path)
    cases = [("frame", BATCH * S_FRAMES, h, h, t, False, cfg.n_layers),
             ("global", BATCH, h, h, S_FRAMES * t, False, cfg.n_layers),
             ("causal check", 1, 4, 4, 300, True, 0), ("gqa check", 1, 8, 2, 500, False, 0)]
    e = _Entry("two_stage_attention", "src/repro_torch/csrc/two_stage_attention.cu",
               "src/repro/kernels/two_stage_attention.py:210")
    attrs, res = _attrs("two_stage_attention", dh, 1.0 / math.sqrt(dh))
    e.d.update(attrs, pq_flips={})
    for label, b, hq, hkv, length, causal, nper in cases:
        args, gqa, vscale = attention_inputs(randn, b, hq, hkv, length, dh)
        got = tsa.two_stage_attention(*args, causal=causal, **gqa)
        want = tsa.two_stage_attention_plain(*args, causal=causal, **gqa)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
        del got, want
        ms = time_ms(lambda: tsa.two_stage_attention(*args, causal=causal, **gqa))
        plain = time_ms(lambda: tsa.two_stage_attention_plain(*args, causal=causal, **gqa),
                        reps=2, warmup=1)
        pairs = length * (length + 1) / 2 if causal else float(length) * length
        nbytes = (b * hq * length * (dh + 4) + 2 * b * hkv * length * dh + b * hkv * length * 4
                  + 4 * b * hq + 4 * b * hq * length * dh)
        # the function's own work, not the kernel's: QK^T once and P.V once
        # (2 ops per multiply-add), and one exp per score (the row max needs
        # none; p = exp(s - m) then feeds both l and pq)
        bound, by = _bound_ms(nbytes, 4.0 * b * hq * pairs * dh, sfu=1.0 * b * hq * pairs)
        lib = None
        if nper:  # the yardstick: bf16 SDPA on the dequantized tensors, made once
            qf = (args[0].float() * args[1]).to(torch.bfloat16).view(b, hq, length, dh)
            kf = (args[2].float() * args[3]).to(torch.bfloat16).view(b, hkv, length, dh)
            vf = (args[4].float() * vscale).to(torch.bfloat16).view(b, hkv, length, dh)
            lib = time_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf))
            ref = F.scaled_dot_product_attention(qf, kf, vf).float().view(b * hq, length, dh)
            rel = ((ref - tsa.two_stage_attention(*args)).norm() / ref.norm()).item()
            print(f"  two-stage int8 vs bf16 SDPA rel L2 = {rel:.3g}")
            del qf, kf, vf, ref
            flips, n = pq_flips(args)
            e.d["pq_flips"][label] = [flips, n]
            print(f"  pq flips vs plain (head 0): {flips} of {n}")
        print(f"two_stage_attention {label:12s} B={b} H={hq} Hkv={hkv} L={length} dh={dh} "
              f"causal={causal}: err={err:.3g} kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"sdpa={'n/a' if lib is None else f'{lib:.4f}ms'} bound={bound:.4f}ms ({by}) "
              f"x{nper}/forward; {res}")
        e.add(err, nper, ms, plain, bound, by, lib)
    return e.done()


# Tolerances of the fused kernels against their plain versions.  Both
# quantize the same float values, but the kernels' sums (norm statistics,
# the H_128 factor, the IDCT) run in another order, so an int8 value within
# an ulp of a rounding boundary may differ by one step (~1 in 1e5).  So:
# int8 outputs within ±1 on at most 0.1% of entries; float outputs fed by
# an in-kernel quantization within rel L2 1e-3 of the plain version (one
# flipped input entry moves its row by ~1e-3), and within 1e-5 of the plain
# version fed the kernel's own int8 prologue output (norm_quant runs the
# same device code); the FFN, whose hidden is requantized in the kernel,
# within 1e-3.
FLIP_SHARE = 1e-3


def _fused_ops(m, k, n, *, prologue, idct, wht_block=None, act=False):
    """f32 operations (and special-function results) of one fused linear:
    the IDCT's ``IDCT_OPS`` per output, the prologue's ~5 per input element
    plus the WHT's log2(block) adds, 3 per output for scale and bias, and
    the activation's ~8 plus one tanh/exp per output."""
    f32 = m * n * (3 + (IDCT_OPS if idct else 0) + (8 if act else 0))
    if prologue:
        f32 += m * k * (5 + (math.log2(wht_block) if wht_block else 0))
    return f32, (m * n if act else 0)


def _kernel_fused_matmul(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.core import versaq as V
    from repro_torch.core.quantize import quantize_per_token, quantize_weight
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import time_ms

    d = cfg.d_model
    u = V.make_folded_norm("ln", d, device=dev).u
    # (label, M, K, N, w_bits, a_bits, norm, pro WHT, act, epi WHT, requant, IDCT,
    #  pre-quantized, launches per forward of the fused path)
    cases = [
        ("wqkv", m, d, 3 * d, 4, 8, "ln", False, "none", False, None, True, False, 2 * cfg.n_layers),
        ("wo", m, d, d, 4, 8, None, False, "none", False, None, True, False, 2 * cfg.n_layers),
        ("w8 ragged M", 1000, d, d, 8, 8, "rms", True, "none", False, None, True, False, 0),
        ("a4 gelu", 1000, d, 1024, 4, 4, "ln", True, "gelu", False, None, True, False, 0),
        ("requant a8", 1000, d, 4096, 4, 8, None, False, "gelu", True, 8, False, False, 0),
        ("requant a4", 777, d, 1024, 8, 4, "rms", False, "silu", True, 4, True, False, 0),
        ("prequant", 1000, 4096, d, 4, 8, None, False, "none", False, None, True, True, 0),
    ]
    e = _Entry("fused_matmul", "src/repro_torch/csrc/fused_matmul.cu",
               "src/repro/kernels/fused.py:358",
               library_note="no single PyTorch call computes norm+WHT+quantize+int matmul+IDCT")
    attrs, res = _attrs("fused_matmul", 3 * d, d, 0, 0)  # at wqkv's widths
    e.d.update(attrs)
    for (label, mm, k, n, wb, ab, norm, pwht, act, ewht, rq, idct, preq, nper) in cases:
        wq = quantize_weight(randn(k, n) / math.sqrt(k), wb)
        ws = wq.scale.reshape(1, -1).contiguous()
        bias = randn(n)
        x = randn(mm, k)
        pro_b = k if pwht else None
        kw = dict(packed=wq.packed, a_bits=ab, norm_kind=norm, pro_wht_block=pro_b, act=act,
                  epi_wht_block=n if ewht else None, requant_bits=rq,
                  dct_block=64 if idct else None)
        xs, nu = None, (u if norm == "ln" else None)
        if preq:
            xq = quantize_per_token(x, ab)
            x, xs = xq.values, xq.scale
            kw.update(norm_kind=None, pro_wht_block=None)
        args = (x, wq.values, ws, xs, bias, nu)
        got = fz.fused_matmul(*args, **kw)
        want = fz.fused_matmul_plain(*args, **kw)
        torch.cuda.synchronize()
        if rq is None:
            err = (got - want).abs().max().item()
            rel = _rel(torch, got, want)
            _check(rel < (1e-5 if preq else 1e-3), f"fused_matmul {label}: rel L2 {rel}")
            note = f"rel={rel:.3g}"
            if not preq:
                q, s = fz.norm_quant(x, nu, norm_kind=norm, wht_block=pro_b, a_bits=ab)
                exact = fz.fused_matmul_plain(q, wq.values, ws, s, bias, **{**kw, "norm_kind": None})
                rel_x = _rel(torch, got, exact)
                _check(rel_x < 1e-5, f"fused_matmul {label}: vs its own prologue {rel_x}")
                note += f" rel(own prologue)={rel_x:.3g}"
        else:
            flips = _q_flips(torch, got[0], want[0])
            _check(flips <= FLIP_SHARE * got[0].numel(), f"fused_matmul {label}: {flips} flips")
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
            err = (got[1] - want[1]).abs().max().item()
            note = f"int8 flips={flips}"
        del got, want
        ms = time_ms(lambda: fz.fused_matmul(*args, **kw))
        plain = time_ms(lambda: fz.fused_matmul_plain(*args, **kw), reps=3, warmup=1)
        in_bytes = mm * k + 4 * mm if preq else 4 * mm * k + (4 * k if nu is not None else 0)
        out_bytes = mm * n + 4 * mm if rq else 4 * mm * n
        nbytes = in_bytes + wq.values.numel() + 8 * n + (16384 if idct else 0) + out_bytes
        f32, sfu = _fused_ops(mm, k, n, prologue=not preq, idct=idct, wht_block=pro_b,
                              act=act != "none")
        if ewht:
            f32 += mm * n * (math.log2(n) + 2)
        bound, by = _bound_ms(nbytes, 2.0 * mm * k * n, sfu=sfu, f32_ops=f32)
        print(f"fused_matmul {label:12s} M={mm} K={k} N={n} W{wb}A{ab} norm={norm} "
              f"pro_wht={pwht} act={act} epi_wht={ewht} requant={rq} idct={idct} prequant={preq}: "
              f"err={err:.3g} {note} kernel={ms:.4f}ms plain={plain:.4f}ms bound={bound:.4f}ms "
              f"({by}) x{nper}/forward; {res}")
        e.add(err, nper, ms, plain, bound, by)
    return e.done()


def _kernel_fused_ffn(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import ffn_inputs, time_ms

    d, dff = cfg.d_model, cfg.d_ff
    # (label, M, D, d_ff, w_bits, a_bits, gated, norm, input WHT, launches per forward)
    cases = [("vggt-1b FFN", m, d, dff, 4, 8, False, "ln", False, 2 * cfg.n_layers),
             ("gated silu", 1000, d, 2816, 4, 8, True, "rms", False, 0),
             ("w8 input wht", 333, 512, 1536, 8, 8, True, None, True, 0)]
    e = _Entry("fused_ffn", "src/repro_torch/csrc/fused_ffn.cu", "src/repro/kernels/fused.py:512",
               library_note="no single PyTorch call computes the quantized FFN layer")
    attrs, res = _attrs("fused_ffn", d, dff, 1)  # at the served widths
    e.d.update(attrs)
    for label, mm, dd, ff, wb, ab, gated, norm, pwht, nper in cases:
        args, kw = ffn_inputs(randn, mm, dd, ff, w_bits=wb, a_bits=ab, gated=gated, norm=norm,
                              pro_wht=pwht)
        hblock = kw["mid_wht_block"]
        got = fz.fused_ffn(*args, **kw)
        want = fz.fused_ffn_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = _rel(torch, got, want)
        _check(rel < 1e-3, f"fused_ffn {label}: rel L2 {rel}")
        del got, want
        per_sm = fz._blocks_per_sm("fused_ffn", dev, dd, ff, 1)
        grid = fz.grid_for(dev, -(-mm // fz.FFN_BM), per_sm)
        scratch = grid * fz.FFN_BM * (4 * ff + max(dd, ff)) / 1e6
        ms = time_ms(lambda: fz.fused_ffn(*args, **kw))
        plain = time_ms(lambda: fz.fused_ffn_plain(*args, **kw), reps=3, warmup=1)
        wbytes = sum(w.numel() for w in (args[1], args[3], args[5]) if w is not None)
        nbytes = 4 * mm * dd * 2 + wbytes + 4 * (3 * ff + 2 * dd) + 16384
        mats = 3 if gated else 2
        int8 = 2.0 * mm * dd * ff * (mats - 1) + 2.0 * mm * ff * dd
        f32 = (mm * dd * (5 + (math.log2(dd) if pwht else 0))  # prologue
               + mm * ff * (mats - 1) * (3 + IDCT_OPS)  # gate/up: scale, IDCT, bias
               + mm * ff * (8 + math.log2(hblock) + 2 + 3)  # act, hidden WHT, requant
               + mm * dd * (3 + IDCT_OPS))  # down: scale, IDCT, bias
        bound, by = _bound_ms(nbytes, int8, sfu=mm * ff, f32_ops=f32)
        print(f"fused_ffn {label:12s} M={mm} D={dd} d_ff={ff} W{wb}A{ab} gated={gated} "
              f"norm={norm} input_wht={pwht}: err={err:.3g} rel={rel:.3g} kernel={ms:.4f}ms "
              f"plain={plain:.4f}ms bound={bound:.4f}ms ({by}) x{nper}/forward; grid {grid} "
              f"blocks ({per_sm}/SM), scratch {scratch:.1f} MB; {res}")
        e.add(err, nper, ms, plain, bound, by)
    return e.done()


def _kernel_norm_quant(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.core import versaq as V
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import time_ms

    d = cfg.d_model
    # (label, M, D, norm, WHT, bits, launches per prologue pass): the served
    # call, then one case for each other instance the kernel dispatches to
    # (register rows of 1, 2, 4, 16 and 32 chunks a lane; the shared-memory
    # routine for D % 128 != 0)
    cases = [("served ln+wht", m, d, "ln", True, 8, 1), ("rms a4 ragged", 999, 4096, "rms", True, 4, 0),
             ("none no-wht", 1000, 768, None, False, 8, 0), ("ln D=128", 777, 128, "ln", True, 8, 0),
             ("rms D=256", 500, 256, "rms", True, 4, 0), ("ln D=512", 600, 512, "ln", True, 8, 0),
             ("ln D=2048", 1000, 2048, "ln", True, 8, 0), ("ln D=96 smem", 333, 96, "ln", True, 8, 0)]
    e = _Entry("norm_quant", "src/repro_torch/csrc/norm_quant.cu", "src/repro/kernels/fused.py:195",
               library_note="no single PyTorch call computes norm+WHT+per-token quantization")
    e.d.update(_attrs("norm_quant", d)[0])  # at the served width
    for label, mm, dd, norm, wht, bits, nper in cases:
        x = randn(mm, dd)
        kw = dict(norm_kind=norm, wht_block=(dd & -dd) if wht else None, a_bits=bits)
        nu = V.make_folded_norm("ln", dd, device=dev).u if norm == "ln" else None
        q, s = fz.norm_quant(x, nu, **kw)
        wq, ws = fz.norm_quant_plain(x, nu, **kw)
        torch.cuda.synchronize()
        flips = _q_flips(torch, q, wq)
        _check(flips <= FLIP_SHARE * q.numel(), f"norm_quant {label}: {flips} flips")
        torch.testing.assert_close(s, ws, rtol=1e-5, atol=0)
        err = (s - ws).abs().max().item()
        ms = time_ms(lambda: fz.norm_quant(x, nu, **kw))
        plain = time_ms(lambda: fz.norm_quant_plain(x, nu, **kw), reps=5)
        f32 = mm * dd * (5 + (math.log2(kw["wht_block"]) + 2 if wht else 0) + 3)
        nbytes = 5 * mm * dd + 4 * mm
        bound, by = _bound_ms(nbytes, f32_ops=f32)
        print(f"norm_quant {label:14s} M={mm} D={dd} norm={norm} wht={wht} A{bits}: "
              f"scale err={err:.3g} int8 flips={flips} kernel={ms:.4f}ms "
              f"({nbytes / ms / 1e9:.3f} TB/s) plain={plain:.4f}ms bound={bound:.4f}ms ({by}) "
              f"x{nper}/pass; {_attrs('norm_quant', dd)[1]}")
        e.add(err, nper, ms, plain, bound, by)
    return e.done()


def _kernel_wht(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.core import transforms
    from repro_torch.kernels import wht as whtk
    from repro_torch.kernels.measure import time_ms

    # the served call, then one case for each other instance the kernel
    # dispatches to (register rows of 1, 2, 4, 8 and 16 chunks a lane; the
    # shared-memory routine for d % 128 != 0)
    cases = [("ffn hidden", m, cfg.d_ff, None, 1), ("d=1024 blk128", 1000, 1024, 128, 0),
             ("d=64", 999, 64, None, 0), ("d=128", 700, 128, None, 0),
             ("d=256 blk64", 500, 256, 64, 0), ("d=512", 600, 512, None, 0),
             ("d=2048", 1000, 2048, None, 0)]
    e = _Entry("wht", "src/repro_torch/csrc/wht.cu", "src/repro/kernels/wht.py:74")
    e.d.update(_attrs("wht", cfg.d_ff)[0])  # at the served width
    for label, r, d, block, nper in cases:
        x = randn(r, d)
        got = whtk.wht(x, block=block)
        want = whtk.wht_plain(x, block=block)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = _rel(torch, got, want)
        _check(rel < 1e-6, f"wht {label}: rel L2 {rel}")
        blk = block or transforms.block_size_for(d)
        ms = time_ms(lambda: whtk.wht(x, block=block))
        plain = time_ms(lambda: whtk.wht_plain(x, block=block), reps=5)
        # the yardstick: one f32 matmul with the blocked Hadamard (TF32 off)
        hb = transforms.hadamard_matrix(blk, device=dev)
        xb = x.view(r, d // blk, blk)
        lib = time_ms(lambda: torch.matmul(xb, hb))
        lrel = _rel(torch, torch.matmul(xb, hb).view(r, d), want)
        nbytes = 8.0 * r * d
        bound, by = _bound_ms(nbytes, f32_ops=r * d * (math.log2(blk) + 2))
        print(f"wht {label:14s} R={r} d={d} block={blk}: err={err:.3g} rel={rel:.3g} "
              f"kernel={ms:.4f}ms ({nbytes / ms / 1e9:.3f} TB/s) plain={plain:.4f}ms "
              f"matmul={lib:.4f}ms (rel {lrel:.3g}) bound={bound:.4f}ms ({by}) x{nper}/pass; "
              f"{_attrs('wht', d)[1]}")
        e.add(err, nper, ms, plain, bound, by, lib)
    return e.done()


# ---------------------------------------------------------------------------
# phase 3: whole model, kernels vs plain versions
# ---------------------------------------------------------------------------


class _PlainKernels:
    """Route the kernel wrappers to their plain versions for CUDA tensors
    too, for the duration of a with-block (the comparison runs only)."""

    def _mods(self):
        from repro_torch.kernels import fused as fz
        from repro_torch.kernels import quant_matmul as qm
        from repro_torch.kernels import two_stage_attention as tsa
        from repro_torch.kernels import wht as whtk

        return [(qm, "quant_matmul"), (tsa, "two_stage_attention"), (fz, "fused_matmul"),
                (fz, "fused_ffn"), (fz, "norm_quant"), (whtk, "wht")]

    def __enter__(self):
        self._saved = []
        for mod, name in self._mods():
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, f"{name}_plain"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _rel_l2(torch, got: dict, want: dict) -> dict:
    return {k: ((got[k] - want[k]).norm() / want[k].norm()).item()
            for k in ("pose", "points", "depth")}


def _scenes(torch, dev, n: int, step: int):
    from repro_torch.data.pipeline import scene_batch

    return torch.as_tensor(scene_batch(n, S_FRAMES, N_PATCHES, 1024, step, seed=0)["patches"],
                           device=dev)


def _plan(fused: bool):
    from repro_torch.core.precision.plan import PrecisionPlan

    return PrecisionPlan(default="w4a8", use_kernel=True, fuse=fused)


def phase_model(torch, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_vggt
    from repro_torch.kernels import probe
    from repro_torch.kernels.measure import time_ms
    from repro_torch.models import vggt

    cfg = get_config("vggt-1b").with_(n_layers=2, attn_impl="two_stage")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(2))
    x = _scenes(torch, dev, BATCH, step=100)
    want_launches = {False: {"quant_matmul": 24, "two_stage_attention": 4},
                     True: {"fused_matmul": 8, "fused_ffn": 4, "two_stage_attention": 4}}
    trees = {}
    for fused in (False, True):
        with torch.inference_mode():
            qp = trees[fused] = quantize_vggt(cfg, params, _plan(fused))
            with probe.tracking() as log:
                got = vggt.forward(cfg, qp, x)
            torch.cuda.synchronize()
            with _PlainKernels():
                want = vggt.forward(cfg, qp, x)
            torch.cuda.synchronize()
            ms = time_ms(lambda: vggt.forward(cfg, qp, x), reps=3, warmup=1)
            with _PlainKernels():
                plain = time_ms(lambda: vggt.forward(cfg, qp, x), reps=2, warmup=0)
        _check(log.by_name() == want_launches[fused],
               f"2-pair forward (fused={fused}) launches {log.by_name()}")
        rel = _rel_l2(torch, got, want)
        print(f"model (vggt-1b width, 2 AA pairs, {BATCH}x{S_FRAMES}x{N_PATCHES}, fused={fused}): "
              f"kernels vs plain rel L2 {rel}; forward kernels={ms:.2f}ms plain={plain:.2f}ms")
        _check(all(v < 1e-3 for v in rel.values()), f"model kernels vs plain: {rel}")
        check_blocks(torch, cfg, qp, x, f"model fused={fused}",
                     other=trees[False] if fused else None)


# ---------------------------------------------------------------------------
# phases 4-5: the served paths
# ---------------------------------------------------------------------------


def phase_serve(torch, dev, *, fused: bool, compare: dict | None = None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_vggt
    from repro_torch.kernels import probe
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    tag = "serve fused" if fused else "serve unfused"
    gc.collect()  # an earlier engine (a reference cycle through its queue) must not count
    torch.cuda.empty_cache()
    cfg = get_config("vggt-1b")

    def weights():  # vggt-1b's random weights, the same for both plans
        return vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    eng = VGGTEngine(cfg, weights(), policy=_plan(fused), attn_impl="two_stage", max_batch=BATCH,
                     device="cuda")
    t0 = time.perf_counter()
    served = eng.params  # quantize once, before the measured requests
    torch.cuda.synchronize()
    print(f"{tag}: quantized vggt-1b ({cfg.n_layers} AA pairs) in {time.perf_counter() - t0:.1f}s")
    requests = [_scenes(torch, dev, 1, step=r) for r in range(4)]
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reqs, latency = [], {}
    t_all = time.perf_counter()
    with probe.tracking() as log:  # counts start at 0 here and cover exactly the served run
        for x in requests:
            reqs.append(eng.enqueue(x))  # every 2nd request fills the group and runs it
            now = time.perf_counter()
            for i, r in enumerate(reqs):
                if r.ready and i not in latency:
                    latency[i] = now - r.t_enqueue
        eng.flush()
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = log.by_name()
    calls = eng.stats.calls
    print(f"{tag}: launches {counts} over {calls} forwards")
    _check(calls == 2, f"expected 2 micro-batched forwards, got {calls}")
    pairs = cfg.n_layers
    want = ({"fused_matmul": 4 * pairs, "fused_ffn": 2 * pairs, "two_stage_attention": 2 * pairs}
            if fused else {"quant_matmul": 12 * pairs, "two_stage_attention": 2 * pairs})
    _check(counts == {k: v * calls for k, v in want.items()},
           f"{tag}: launches {counts}, expected {want} per forward")
    outs = [r.result() for r in reqs]
    for o in outs:
        for k in ("pose", "points", "depth", "conf"):
            _check(bool(torch.isfinite(o[k]).all()), f"{tag}: {k} not finite")
        _check(tuple(o["points"].shape) == (1, S_FRAMES, N_PATCHES, 3), f"{tag}: points shape")
    _check(len(latency) == 4, "every request answered")
    p50 = statistics.median(latency.values()) * 1e3
    print(f"{tag}: 4 requests x 1 scene ({S_FRAMES} frames x {N_PATCHES} patches), max_batch="
          f"{BATCH}: p50 request latency {p50:.1f}ms, {4 / wall:.2f} scenes/s, "
          f"peak memory {peak:.2f} GiB")
    print(eng.stats.format())

    # the first micro-batch against a plain-version forward of the same weights
    first = torch.cat(requests[:2], dim=0)
    with torch.inference_mode(), _PlainKernels():
        plain = vggt.forward(eng.cfg, served, first)
    got = {k: torch.cat([outs[0][k], outs[1][k]], dim=0) for k in ("pose", "points", "depth")}
    rel = _rel_l2(torch, got, plain)
    print(f"{tag}: served vs plain-version forward ({pairs} AA pairs) rel L2 {rel}")
    _check(all(v < 1e-3 for v in rel.values()), f"{tag}: served vs plain forward: {rel}")
    _check(all(math.isfinite(v) for v in rel.values()), "non-finite comparison")
    del plain
    other = None
    if compare is not None:
        rels = [_rel_l2(torch, o, c) for o, c in zip(outs, compare["outs"])]
        worst = {k: max(r[k] for r in rels) for k in rels[0]}
        print(f"{tag}: fused vs unfused plan on the same weights, worst request rel L2 {worst}")
        _check(all(v < 1e-2 for v in worst.values()), f"fused vs unfused: {worst}")
        with torch.inference_mode():  # made after the measured run, so its peak memory holds
            other = quantize_vggt(eng.cfg, weights(), _plan(False))
    check_blocks(torch, eng.cfg, served, first, tag, other=other)
    del other
    batches = [torch.cat(requests[i:i + BATCH], dim=0) for i in range(0, len(requests), BATCH)]
    inplace = profile_forwards(torch, [lambda x=x: vggt.forward(eng.cfg, served, x)
                                       for x in batches])
    return {"counts": counts, "runs": calls, "inplace": inplace,
            "outs": [{k: o[k] for k in ("pose", "points", "depth")} for o in outs]}


def _branches(torch, block, p, cfg, x, kv_mask):
    """The two residual branches ``block`` (``vggt._block``) adds to the
    stream ``x`` (the attention output and the FFN output, LayerScale
    folded in), and the block's output."""
    from repro_torch.models import attention as A
    from repro_torch.models import ffn as F

    outs, attn, ffn = [], A.gqa_attention, F.dense_ffn

    def keep(fn):
        def run(*a, **kw):
            outs.append(fn(*a, **kw))
            return outs[-1]
        return run

    A.gqa_attention, F.dense_ffn = keep(attn), keep(ffn)
    try:
        y = block(p, cfg, x, kv_mask=kv_mask)
    finally:
        A.gqa_attention, F.dense_ffn = attn, ffn
    return outs, y


def check_blocks(torch, cfg, served, x, tag, other=None) -> None:
    """One forward of ``served`` on ``x``; at every block, its residual
    branches with the kernels against the same block with the plain
    versions (rel L2 < 1e-3) and, given ``other`` (the other plan's tree on
    the same weights), against that plan's block (< 1e-2), all fed the
    stream this forward reaches the block with.  A branch's relative error
    does not shrink with LayerScale, so a wrong block fails here."""
    from repro_torch.models import vggt
    from repro_torch.tree import tree_index

    block, calls = vggt._block, []
    worst = {"plain": [0.0, 0.0], "other": [0.0, 0.0]}

    def checked(p, cfg_, xin, kv_mask=None):
        i = len(calls)
        calls.append(i)
        got, y = _branches(torch, block, p, cfg_, xin, kv_mask)
        with _PlainKernels():
            want, _ = _branches(torch, block, p, cfg_, xin, kv_mask)
        refs = {"plain": want}
        if other is not None:
            op = tree_index(other["blocks"], i // 2)["frame" if i % 2 == 0 else "global"]
            refs["other"], _ = _branches(torch, block, op, cfg_, xin, kv_mask)
        for name, ref in refs.items():
            for j in (0, 1):
                worst[name][j] = max(worst[name][j], _rel(torch, got[j], ref[j]))
        return y

    vggt._block = checked
    try:
        with torch.inference_mode():
            vggt.forward(cfg, served, x)
    finally:
        vggt._block = block
    _check(len(calls) == 2 * cfg.n_layers, f"{tag}: {len(calls)} blocks checked")
    print(f"{tag}: per-block residual branches over {len(calls)} blocks, worst rel L2 "
          f"(attention, FFN): kernels vs plain {worst['plain']}"
          + ("" if other is None else f", vs the other plan {worst['other']}"))
    _check(max(worst["plain"]) < 1e-3, f"{tag}: a block's branch vs plain: {worst['plain']}")
    if other is not None:
        _check(max(worst["other"]) < 1e-2, f"{tag}: a block's branch vs the other plan: "
               f"{worst['other']}")


def profile_forwards(torch, fwds) -> dict[str, float]:
    """Replay a served run's forwards under torch.profiler.  Prints, per
    forward, the device time of the hand-written kernels and of the PyTorch
    operators between them, and the device's idle share of the (profiled,
    so slightly slower) wall time.  Returns each kernel's in-place device
    time summed over the forwards (empty if the profiler saw no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fwd in fwds:
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device time")
        return {}
    n = len(fwds)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ours = {}
    for e in kernels:
        for name in KERNELS:
            if f"{name}_kernel" in e.name:
                ours[name] = ours.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"profile: {n} forwards, per forward {wall_ms / n:.1f}ms wall, device busy "
          f"{busy / n:.1f}ms (idle {100 * (1 - busy / wall_ms):.1f}%), hand-written kernels "
          + ", ".join(f"{k} {v / n:.1f}ms" for k, v in ours.items())
          + f", everything else {(busy - sum(ours.values())) / n:.1f}ms")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  profile op {e.key:32s} calls/forward={e.count / n:7.1f} "
              f"device/forward={e.self_device_time_total / 1e3 / n:9.2f}ms")
    return ours


# ---------------------------------------------------------------------------
# phase 6: the shared prologue and the stand-alone WHT
# ---------------------------------------------------------------------------


def phase_prologue(torch, dev) -> dict:
    """One Q/K/V input quantized once by ``norm_quant_prologue`` and fed to
    three pre-quantized ``fused_linear`` launches; ``online_wht_2d`` over
    the FFN hidden's shape.  Checked against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.core import versaq as V
    from repro_torch.kernels import ops, probe

    cfg = get_config("vggt-1b")
    d, t = cfg.d_model, cfg.n_special_tokens + N_PATCHES
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((BATCH, S_FRAMES, t, d), generator=gen, device=dev)
    hidden = torch.randn((BATCH * S_FRAMES * t, cfg.d_ff), generator=gen, device=dev)
    pol = V.QuantPolicy(4, 8, "versaq")
    sites = [V.prepare_linear(torch.randn((d, d), generator=gen, device=dev) / math.sqrt(d), pol,
                              rotate_in_offline=True, use_kernel=True, epilogue=V.Epilogue())
             for _ in range(3)]
    u = V.make_folded_norm("ln", d, device=dev).u

    def run():
        qt = ops.norm_quant_prologue(x, norm="ln", norm_u=u, wht=True)
        return [ops.fused_linear(qt, s) for s in sites], ops.online_wht_2d(hidden)

    with probe.tracking() as log:  # counts start at 0 here and cover exactly this pass
        outs, rot = run()
    torch.cuda.synchronize()
    counts = log.by_name()
    _check(counts == {"norm_quant": 1, "fused_matmul": 3, "wht": 1}, f"prologue launches {counts}")
    with _PlainKernels():
        want_outs, want_rot = run()
    rels = [_rel(torch, a, b) for a, b in zip(outs, want_outs)] + [_rel(torch, rot, want_rot)]
    print(f"prologue: launches {counts}; q/k/v vs plain rel L2 {rels[:3]}, wht {rels[3]:.3g}")
    _check(all(r < 1e-3 for r in rels[:3]) and rels[3] < 1e-6, f"prologue vs plain: {rels}")
    return {"counts": counts, "runs": 1, "inplace": {}}


if __name__ == "__main__":
    sys.exit(main())
