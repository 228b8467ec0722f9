"""Host utilities: validation figures (viz), and the profiler traces and
spans of host work (profiling)."""
