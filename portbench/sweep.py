"""Find an open-loop cell's knee: the highest arrival rate the port
sustains without a growing backlog.  One process, one set-up (weights of
the first seed), then one window per rate and seed (the cell's traffic
with only the rate changed):

    python3 portbench/sweep.py --workload CELL --seeds N,M --seconds 50 --rates 4,4.25,4.5

Per window it prints the requests due and completed, the p50 and p95
latency from the due time, and the growth of the backlog: the
least-squares slope of a request's latency against its due time, in
seconds per second (about 0 when the port keeps up; 1 - capacity / rate
above capacity).  The knee is the highest rate at which that rate and
every lower one read a slope under ``KNEE_SLOPE`` on the mean of the
seeds."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [os.path.join(ROOT, "src"), ROOT]

from portbench import harness  # noqa: E402
from portbench.drivers import common  # noqa: E402
from portbench.stats import percentile  # noqa: E402

KNEE_SLOPE = 0.02  # latency growing by 1 s over a 50 s window


def slope(xs: list[float], ys: list[float]) -> float:
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0


def main(argv) -> int:
    import torch

    from portbench.drivers import vggt

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    man = harness.manifest()
    wl, config, traffic, _ = harness.cell_files(man, args.workload)
    print(f"device: {harness.require_chips(wl['chips'])}; {harness.power_line()}", flush=True)
    dev = torch.device("cuda")
    base = harness.Run(cell=args.workload, config=config, traffic=traffic, seed=seeds[0],
                       window_s=args.seconds, trace=False)
    harness.build_kernels(base)
    win = common.Window(base)
    eng, undo = vggt.build(base, dev, config["tier"], win)
    print(f"setup {time.perf_counter() - T_PROCESS:.1f} s", flush=True)
    mean_slope = {}
    for rate in [float(r) for r in args.rates.split(",")]:
        slopes = []
        for seed in seeds:
            run = harness.Run(cell=args.workload, config=config,
                              traffic=dict(traffic, rate_per_s=rate), seed=seed,
                              window_s=args.seconds, trace=False)
            win.run, win.t0 = run, None
            vggt.serve(run, eng, win, dev, T_PROCESS)
            reqs = run.in_window()
            lat = [r.done - r.due if r.ok else float("inf") for r in reqs]
            third = max(1, len(reqs) // 3)
            first, last = sum(lat[:third]) / third, sum(lat[-third:]) / third
            slopes.append(slope([r.due for r in reqs], lat))
            late = max(r.sent - r.due for r in reqs)
            print(f"rate {rate:.3f}/s seed {seed}: due {len(reqs)} completed "
                  f"{sum(r.ok for r in reqs)} p50 {percentile(lat, 50) * 1e3:.1f} ms "
                  f"p95 {percentile(lat, 95) * 1e3:.1f} ms slope {slopes[-1]:.4f} "
                  f"last/first third {last / first:.2f} generator late <= {late * 1e3:.0f} ms "
                  f"forwards {len(run.batches)} mean batch "
                  f"{run.stats['items'] / max(1, run.stats['calls']):.3f}; {run.notes[-1]}",
                  flush=True)
        mean_slope[rate] = sum(slopes) / len(slopes)
        print(f"rate {rate:.3f}/s: mean slope {mean_slope[rate]:.4f}", flush=True)
    knee = None
    for rate in sorted(mean_slope):
        if mean_slope[rate] >= KNEE_SLOPE:
            break
        knee = rate
    print(f"knee (mean slope under {KNEE_SLOPE} here and at every lower rate): {knee}", flush=True)
    undo()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
