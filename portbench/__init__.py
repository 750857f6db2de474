"""The benchmark of sleepgen_torch: see run.py and BENCHMARK.json."""
