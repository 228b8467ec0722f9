"""Peak device memory allocated over the window
(``torch.cuda.max_memory_allocated`` after a reset), in GiB."""


def read(run):
    return run["device"]["memory_peak_bytes"] / 2 ** 30
