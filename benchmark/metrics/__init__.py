"""Part of the benchmark (see benchmark/run.py)."""
