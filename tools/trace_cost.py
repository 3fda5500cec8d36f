"""Run one cell of BENCHMARK.json with the port's span tracer installed
for the whole process (the server's default ring of 2048 events) and the
profiler off, to set beside an untraced run of the same cell and seed:
what tracing costs when it is on.

    python3 tools/trace_cost.py --workload CELL --seed N --seconds S --trace 0

Takes ``portbench/run.py``'s arguments and prints its result line."""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [os.path.join(ROOT, "src"), ROOT]

from portbench.harness import main  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

if __name__ == "__main__":
    trace.install(trace.Tracer())
    sys.exit(main(sys.argv[1:], T_PROCESS))
