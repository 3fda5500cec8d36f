"""What the profiled sub-window says: device busy time, kernels by name,
kernels attributed to the engine calls that launched them, and the idle
gaps labelled by what the host was doing."""
from __future__ import annotations

import importlib

from portbench.devtrace import gaps, kernel_function, union_s

# the port's hand-written CUDA kernels (src/repro_torch/csrc/*.cu)
HAND_WRITTEN = ("quant_matmul_kernel", "two_stage_attention_kernel", "fused_matmul_kernel",
                "fused_ffn_kernel", "norm_quant_kernel", "norm_quant_rows_kernel", "wht_kernel",
                "wht_rows_kernel")


def driver(run):
    return importlib.import_module(f"portbench.drivers.{run.config['driver']}")


def window(run):
    return (run.profile or {}).get("window")


def kernels_in(run) -> list:
    """Device activities clipped to the profiled sub-window."""
    w = window(run)
    if w is None:
        return []
    a, b = w
    return [(n, max(t0, a), min(t1, b)) for n, t0, t1 in run.profile["kernels"] if t1 > a and t0 < b]


def busy_window(run) -> tuple[float, float]:
    w = window(run)
    if w is None:
        return 0.0, 0.0
    return union_s([(t0, t1) for _, t0, t1 in kernels_in(run)]), w[1] - w[0]


def attributed(run) -> list:
    """(engine call, its kernels) for each call wholly inside the profiled
    sub-window; a kernel belongs to the call whose host span holds its
    start (each call ends with a synchronise)."""
    w = window(run)
    if w is None or not run.profile["kernels"]:
        return []
    ks = run.profile["kernels"]
    out = []
    for b in run.batches:
        if b.t0 >= w[0] and b.t1 <= w[1]:
            out.append((b, [k for k in ks if b.t0 <= k[1] <= b.t1]))
    return out


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def outstanding(run) -> list:
    """Union of the intervals in which some request was owed and not done."""
    end = max([r.done for r in run.requests if r.done is not None] + [run.window_s])
    return merged([(r.start, r.done if r.done is not None else end) for r in run.requests
                   if r.start is not None])


def overlap(x: tuple, ys: list) -> float:
    return sum(max(0.0, min(x[1], b) - max(x[0], a)) for a, b in ys)


def label(run, t: float) -> str:
    for b in run.batches:
        if b.t0 <= t <= b.t1:
            return "host inside an engine call"
    for a, b in outstanding(run):
        if a <= t <= b:
            return "request queued, no engine call"
    return "no request outstanding"


def breakdown(run) -> dict:
    ks = kernels_in(run)
    w = window(run)
    if not ks or w is None:
        return {"device_ops": [], "idle_gaps": []}
    by = {}
    for n, t0, t1 in ks:
        fn = kernel_function(n)
        key = fn if fn in HAND_WRITTEN else n[:120]
        by[key] = by.get(key, 0.0) + (t1 - t0)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps([(t0, t1) for _, t0, t1 in ks], w[0], w[1]), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[label(run, (a + b) / 2), b - a] for a, b in idle]}


def roofline(run, kernel: str) -> float | None:
    """Percent of the roofline bound reached by ``kernel``'s launches in the
    calls of the profiled sub-window: summed bound over summed device time.
    A call whose launches the trace did not hold as the counter expects is
    left out (and noted); None when no call is left."""
    drv = driver(run)
    op = kernel[: -len("_kernel")]
    bound = spent = 0.0
    for b, ks in attributed(run):
        want = [l for l in drv.launches(run, b) if l.kernel == op]
        got = [k for k in ks if kernel_function(k[0]) == kernel]
        if not want or len(got) != len(want):
            run.notes.append(f"roofline {kernel}: a call at batch {b.batch} x {b.length} showed "
                             f"{len(got)} launches, the counter expects {len(want)}; left out")
            continue
        bound += sum(l.bound_s() for l in want)
        spent += sum(t1 - t0 for _, t0, t1 in got)
    return 100.0 * bound / spent if spent else None


def glue_s(run) -> tuple[float, list]:
    """Device seconds of every kernel that is not hand-written, in the
    calls of the sub-window, and those calls."""
    pairs = attributed(run)
    spent = sum(t1 - t0 for _, ks in pairs for n, t0, t1 in ks
                if kernel_function(n) not in HAND_WRITTEN)
    return spent, [b for b, _ in pairs]
