"""Peak device memory allocated over the window of a training cell under
gradient checkpointing (``torch.cuda.max_memory_allocated`` after a
reset), in GiB, as ``peak_gib.train`` reads it."""

from benchmark.metrics._reuse import reader

read = reader("peak_gib.train")
