#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of VersaQ-3D.

Run from the repository root on a machine with one NVIDIA GPU (written for
an H100) and the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and does, in order:

1. builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the served path below gives it (two scenes of S=8 frames x
   P=1024 patches per forward: M = 2 * 8 * 1029 = 16464 tokens), plus a W8,
   a causal and a GQA case; times kernel, plain version, the card's bound
   and a PyTorch library yardstick (``torch._int_mm``,
   ``F.scaled_dot_product_attention``);
3. runs the W4A8 plan's forward at vggt-1b width with 2 AA pairs once with
   the kernels and once with the plain versions and compares them;
4. serves vggt-1b at full width and depth (24 AA pairs, random weights from
   seed 0) with ``PrecisionPlan(default="w4a8", use_kernel=True)`` and
   two-stage attention: 4 requests of one scene each, ``max_batch=2``; counts
   the kernel launches of exactly that run, checks 288 ``quant_matmul`` and
   48 ``two_stage_attention`` launches per forward, finite outputs, and the
   first micro-batch against a plain-version forward of the same weights.

Any failed check raises, so the script exits non-zero.  The kernels' JSON
line carries, per kernel, its launches in the served run; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are isolated timings (each
distinct shape timed once, L2 flushed) weighted by those launches, and
``inplace_ms`` is the kernel's device time when the served run's forwards
are replayed under ``torch.profiler``.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Hopper H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor cores and
# HBM3 bandwidth; the special-function units give 16 results per clock per
# SM: 132 SMs x 16 x 1.83 GHz.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 132 * 16 * 1.83e9

S_FRAMES, N_PATCHES, BATCH = 8, 1024, 2


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
    launches, forwards, inplace = phase_serve(torch, dev)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        _check(k["launches"] > 0, f"{k['name']} was not launched on the served path")
        # per-shape medians x launches per forward -> x forwards of the served run
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            k[key] *= forwards
        k["timing"] = "isolated per-shape medians (L2 flushed) weighted by served-run launches"
        k["inplace_ms"] = inplace.get(k["name"])  # profiler, replay of the served run

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs; a 64 MB buffer is
    rewritten before each run so no input stays in the 50 MB L2."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(nbytes: float, ops: float, sfu: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(ops / PEAK_INT8_OPS, sfu / PEAK_SFU) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel vs its plain version at the served shapes
# ---------------------------------------------------------------------------


def phase_kernels(torch, dev) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import two_stage_attention as tsa

    cfg = get_config("vggt-1b")
    d, dff, h, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    t = cfg.n_special_tokens + N_PATCHES
    m = BATCH * S_FRAMES * t
    per_fwd = 2 * cfg.n_layers  # frame + global blocks per forward
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # ---- quant_matmul: (label, K, N, w_bits, launches per forward) ----
    mm_cases = [
        ("wq/wk/wv/wo", d, d, 4, 4 * per_fwd),
        ("w_up", d, dff, 4, per_fwd),
        ("w_down", dff, d, 4, per_fwd),
        ("w8 check", d, dff, 8, 0),
    ]
    mm = dict(name="quant_matmul", route="cuda", source="src/repro_torch/csrc/quant_matmul.cu",
              replaces="src/repro/kernels/quant_matmul.py:151", max_abs_err=0.0, ms=0.0,
              plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    bound_by = {}
    for label, k, n, bits, nper in mm_cases:
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
        ms = _time_ms(torch, lambda: qm.quant_matmul(*args, packed=wq.packed))
        plain = _time_ms(torch, lambda: qm.quant_matmul_plain(*args, packed=wq.packed), reps=3)
        w_cm = (unpack_int4(wq.values, 0) if wq.packed else wq.values).t().contiguous().t()
        lib = _time_ms(torch, lambda: torch._int_mm(xq.values, w_cm).float() * xq.scale * ws)
        nbytes = m * k + 4 * m + wq.values.numel() + 4 * n + 4 * m * n
        bound, by = _bound_ms(nbytes, 2.0 * m * k * n)
        print(f"quant_matmul {label:12s} M={m} K={k} N={n} W{bits}: err={err:.3g} "
              f"kernel={ms:.4f}ms plain={plain:.4f}ms int_mm={lib:.4f}ms bound={bound:.4f}ms "
              f"({by}) x{nper}/forward")
        mm["max_abs_err"] = max(mm["max_abs_err"], err)
        if nper:
            mm["ms"] += nper * ms
            mm["plain_ms"] += nper * plain
            mm["library_ms"] += nper * lib
            mm["bound_ms"] += nper * bound
            bound_by[by] = bound_by.get(by, 0.0) + nper * bound
    mm["bound_by"] = max(bound_by, key=bound_by.get)

    # ---- two_stage_attention: (label, B, H, Hkv, L, causal, launches/forward) ----
    at_cases = [
        ("frame", BATCH * S_FRAMES, h, h, t, False, cfg.n_layers),
        ("global", BATCH, h, h, S_FRAMES * t, False, cfg.n_layers),
        ("causal check", 1, 4, 4, 300, True, 0),
        ("gqa check", 1, 8, 2, 500, False, 0),
    ]
    at = dict(name="two_stage_attention", route="cuda",
              source="src/repro_torch/csrc/two_stage_attention.cu",
              replaces="src/repro/kernels/two_stage_attention.py:210", max_abs_err=0.0, ms=0.0,
              plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    bound_by = {}
    for label, b, hq, hkv, length, causal, nper in at_cases:
        q, k_, v = randn(b * hq, length, dh), randn(b * hkv, length, dh), randn(b * hkv, length, dh)
        qq, kq = quantize_per_token(q, 8), quantize_per_token(k_, 8)
        vscale = torch.clamp_min(v.abs().amax(dim=(1, 2), keepdim=True), 1e-8) / 127.0
        vv = torch.round(v / vscale).clamp(-127, 127).to(torch.int8)
        vsq = vscale.reshape(b, hkv).repeat_interleave(hq // hkv, dim=1).reshape(b * hq, 1, 1)
        gqa = dict(q_heads=hq, kv_heads=hkv) if hq != hkv else {}
        args = (qq.values, qq.scale, kq.values, kq.scale, vv, vsq.contiguous())
        got = tsa.two_stage_attention(*args, causal=causal, **gqa)
        want = tsa.two_stage_attention_plain(*args, causal=causal, **gqa)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
        del got, want
        ms = _time_ms(torch, lambda: tsa.two_stage_attention(*args, causal=causal, **gqa))
        plain = _time_ms(torch, lambda: tsa.two_stage_attention_plain(*args, causal=causal, **gqa),
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
            qf = (qq.values.float() * qq.scale).to(torch.bfloat16).view(b, hq, length, dh)
            kf = (kq.values.float() * kq.scale).to(torch.bfloat16).view(b, hkv, length, dh)
            vf = (vv.float() * vscale).to(torch.bfloat16).view(b, hkv, length, dh)
            lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(qf, kf, vf))
            ref = F.scaled_dot_product_attention(qf, kf, vf).float().view(b * hq, length, dh)
            rel = ((ref - tsa.two_stage_attention(*args)).norm() / ref.norm()).item()
            print(f"  two-stage int8 vs bf16 SDPA rel L2 = {rel:.3g}")
            del qf, kf, vf, ref
        print(f"two_stage_attention {label:12s} B={b} H={hq} Hkv={hkv} L={length} dh={dh} "
              f"causal={causal}: err={err:.3g} kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"sdpa={'n/a' if lib is None else f'{lib:.4f}ms'} bound={bound:.4f}ms ({by}) "
              f"x{nper}/forward")
        at["max_abs_err"] = max(at["max_abs_err"], err)
        if nper:
            at["ms"] += nper * ms
            at["plain_ms"] += nper * plain
            at["library_ms"] += nper * lib
            at["bound_ms"] += nper * bound
            bound_by[by] = bound_by.get(by, 0.0) + nper * bound
    at["bound_by"] = max(bound_by, key=bound_by.get)
    return [mm, at]


# ---------------------------------------------------------------------------
# phase 3: whole model, kernels vs plain versions
# ---------------------------------------------------------------------------


class _PlainKernels:
    """Route the kernel wrappers to their plain versions for CUDA tensors
    too, for the duration of a with-block (the comparison run only)."""

    def __enter__(self):
        from repro_torch.kernels import quant_matmul as qm
        from repro_torch.kernels import two_stage_attention as tsa

        self._saved = (qm.quant_matmul, tsa.two_stage_attention)
        qm.quant_matmul = qm.quant_matmul_plain
        tsa.two_stage_attention = tsa.two_stage_attention_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import quant_matmul as qm
        from repro_torch.kernels import two_stage_attention as tsa

        qm.quant_matmul, tsa.two_stage_attention = self._saved
        return False


def _rel_l2(torch, got: dict, want: dict) -> dict:
    return {k: ((got[k] - want[k]).norm() / want[k].norm()).item()
            for k in ("pose", "points", "depth")}


def _scenes(torch, dev, n: int, step: int):
    from repro_torch.data.pipeline import scene_batch

    return torch.as_tensor(scene_batch(n, S_FRAMES, N_PATCHES, 1024, step, seed=0)["patches"],
                           device=dev)


def phase_model(torch, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_vggt
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.kernels import probe
    from repro_torch.models import vggt

    cfg = get_config("vggt-1b").with_(n_layers=2, attn_impl="two_stage")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(2))
    with torch.inference_mode():
        qp = quantize_vggt(cfg, params, PrecisionPlan(default="w4a8", use_kernel=True))
        x = _scenes(torch, dev, BATCH, step=100)
        with probe.tracking() as log:
            got = vggt.forward(cfg, qp, x)
        torch.cuda.synchronize()
        with _PlainKernels():
            want = vggt.forward(cfg, qp, x)
        torch.cuda.synchronize()
        ms = _time_ms(torch, lambda: vggt.forward(cfg, qp, x), reps=3, warmup=1)
        with _PlainKernels():
            plain = _time_ms(torch, lambda: vggt.forward(cfg, qp, x), reps=2, warmup=0)
    _check(log.by_name() == {"quant_matmul": 24, "two_stage_attention": 4},
           f"2-pair forward launches {log.by_name()}")
    rel = _rel_l2(torch, got, want)
    print(f"model (vggt-1b width, 2 AA pairs, {BATCH}x{S_FRAMES}x{N_PATCHES}): kernels vs plain "
          f"rel L2 {rel}; forward kernels={ms:.2f}ms plain={plain:.2f}ms")
    _check(all(v < 1e-3 for v in rel.values()), f"model kernels vs plain: {rel}")


# ---------------------------------------------------------------------------
# phase 4: the served path at full width and depth
# ---------------------------------------------------------------------------


def phase_serve(torch, dev) -> tuple[dict[str, int], int, dict[str, float]]:
    from repro_torch.configs import get_config
    from repro_torch.core.precision.plan import PrecisionPlan
    from repro_torch.kernels import probe
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    cfg = get_config("vggt-1b")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = VGGTEngine(cfg, params, policy=PrecisionPlan(default="w4a8", use_kernel=True),
                     attn_impl="two_stage", max_batch=BATCH, device="cuda")
    t0 = time.perf_counter()
    served = eng.params  # quantize once, before the measured requests
    torch.cuda.synchronize()
    print(f"serve: quantized vggt-1b ({cfg.n_layers} AA pairs) in {time.perf_counter() - t0:.1f}s")
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
    print(f"serve: launches {counts} over {calls} forwards")
    _check(calls == 2, f"expected 2 micro-batched forwards, got {calls}")
    _check(counts.get("quant_matmul", 0) == 288 * calls,
           f"quant_matmul launches {counts.get('quant_matmul')} != 288/forward")
    _check(counts.get("two_stage_attention", 0) == 48 * calls,
           f"two_stage_attention launches {counts.get('two_stage_attention')} != 48/forward")
    outs = [r.result() for r in reqs]
    for o in outs:
        for k in ("pose", "points", "depth", "conf"):
            _check(bool(torch.isfinite(o[k]).all()), f"served {k} not finite")
        _check(tuple(o["points"].shape) == (1, S_FRAMES, N_PATCHES, 3), "served points shape")
    _check(len(latency) == 4, "every request answered")
    p50 = statistics.median(latency.values()) * 1e3
    print(f"serve: 4 requests x 1 scene ({S_FRAMES} frames x {N_PATCHES} patches), max_batch="
          f"{BATCH}: p50 request latency {p50:.1f}ms, {4 / wall:.2f} scenes/s, "
          f"peak memory {peak:.2f} GiB")
    print(eng.stats.format())

    # the first micro-batch against a plain-version forward of the same weights
    with torch.inference_mode(), _PlainKernels():
        want = vggt.forward(eng.cfg, served, torch.cat(requests[:2], dim=0))
    got = {k: torch.cat([outs[0][k], outs[1][k]], dim=0) for k in ("pose", "points", "depth")}
    rel = _rel_l2(torch, got, want)
    print(f"serve: served vs plain-version forward (24 AA pairs) rel L2 {rel}")
    _check(all(v < 1e-3 for v in rel.values()), f"served vs plain forward: {rel}")
    _check(all(math.isfinite(v) for v in rel.values()), "non-finite comparison")
    batches = [torch.cat(requests[i:i + BATCH], dim=0) for i in range(0, len(requests), BATCH)]
    inplace = profile_forwards(torch, [lambda x=x: vggt.forward(eng.cfg, served, x)
                                       for x in batches])
    return counts, calls, inplace


def profile_forwards(torch, fwds) -> dict[str, float]:
    """Replay the served run's forwards under torch.profiler.  Prints, per
    forward, the device time of the two kernels and of the PyTorch
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
        for name in ("quant_matmul", "two_stage_attention"):
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


if __name__ == "__main__":
    sys.exit(main())
