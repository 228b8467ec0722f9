"""Model FLOPs utilization of training under gradient checkpointing, as
``mfu.train`` computes it over the window: three forwards of every item
at its true length and Prodigy's arithmetic, over the window's seconds
times the float32 peak. The recompute (a fourth forward of the encoder's
layers) is not counted: it is work remat adds, not the model's, so the
share falls by what it costs."""

from benchmark.metrics._reuse import reader

read = reader("mfu.train")
