"""Host utilities: validation figures (viz) and training traces
(profiling)."""
