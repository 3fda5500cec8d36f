"""The port's benchmark: cells driven by ``BENCHMARK.json`` and the data
files under this folder (configurations, traffic mixes, checks, metric
readers), a frozen operation and byte counter, and plain references that
decide ``correct``.  Run ``python3 portbench/run.py --help``."""
