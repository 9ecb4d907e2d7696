"""The port's benchmark: BENCHMARK.json at the repository root, this folder
its harness (``bench.py``)."""
