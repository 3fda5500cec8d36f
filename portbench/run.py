"""Run one cell of BENCHMARK.json on the CUDA device and print its result
line last:

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Needs no environment variable: it puts the port (``src``) and the
checkout root on its own path.  ``--control`` serves the configuration's
lower-precision control tier instead of its tier."""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# this folder's modules are imported as ``portbench.*``, never bare
sys.path[0:1] = [os.path.join(ROOT, "src"), ROOT]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
