"""A cell at smoke size on the CPU, for the benchmark's tests: the same
drivers, traffic loops, checks and readers, with the model cut to the
registry's smoke widths and the traffic to a few short requests; each
cell checks as many requests as it does on the card."""
from __future__ import annotations

import time

from portbench import harness

VGGT = dict(arch="vggt-1b-smoke", n_layers=8, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
            d_ff=1024)
LM = dict(arch="phi3-mini-3.8b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
          head_dim=32, d_ff=256, vocab_size=512)


def shrink(config: dict, traffic: dict) -> tuple[dict, dict]:
    if config["driver"] == "vggt":
        traffic = dict(traffic, frames=2, patches=16, profile_s=0.5)
        if traffic["loop"] == "open":
            traffic["rate_per_s"] = min(traffic["rate_per_s"], 6.0)
        return dict(config, **VGGT), traffic
    pl = dict(traffic["prompt_len"], median=24, min=16, max=32)
    return dict(config, **LM), dict(traffic, prompt_len=pl, max_len=64, prompt_buckets=[16, 32],
                                    clients=2, profile_s=0.5)


def run(cell: str, *, seed: int = 4_000_000_007, seconds: float = 1.0, trace: bool = False,
        control: bool = False, root: str = harness.ROOT, **traffic_kw) -> tuple[harness.Run, dict]:
    """(the run, its result line) of ``cell`` at smoke size on the CPU;
    ``traffic_kw`` override keys of the shrunk traffic mix."""
    man = harness.manifest(root)
    _, config, traffic, limits = harness.cell_files(man, cell, root)
    config, traffic = shrink(config, traffic)
    traffic.update(traffic_kw)
    r = harness.run_cell(cell, config, traffic, seed, seconds, trace,
                         t_process=time.perf_counter(), device="cpu", control=control)
    return r, harness.result_line(r, man, limits, "cpu", 1)
