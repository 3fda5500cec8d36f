"""Gloo ranks on the CPU for the port's multi-rank tests.

``run_ranks(world, case, out_dir)`` starts ``world`` Python processes at
once, each running ``torch_ranks.<case>(rank, world, out_dir)`` inside a
gloo process group that they join through a file
(``init_method="file://..."``: no TCP port), and waits for all of them.
Each rank writes what it computed under ``out_dir``; the test process,
which has JAX, holds it against the reference.  A test file starts its
ranks once, from a module-scoped fixture, and every case of the file reads
the results, so no case pays a process start of its own.

Run as a script, this module is one rank:
``python tests/torch_dist.py CASE RANK WORLD OUT_DIR``.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_ranks(world: int, case: str, out_dir, *, timeout: float = 600.0) -> float:
    """Run ``case`` on ``world`` gloo ranks; return the wall seconds.
    Raises with every rank's output if one fails or the time runs out."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "pg_init").unlink(missing_ok=True)  # a file store is good for one group
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(out_dir / f"rank{r}.log", "w+") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(out_dir)],
                              env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = t0 + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-4000:]}")
        f.close()
    if bad:
        raise RuntimeError(f"{case}: ranks {bad} failed after {seconds:.1f}s\n" + "\n".join(text))
    return seconds


def _main(case: str, rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_ranks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg_init", rank=rank,
                            world_size=world)
    try:
        getattr(torch_ranks, case)(rank, world, pathlib.Path(out_dir))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
