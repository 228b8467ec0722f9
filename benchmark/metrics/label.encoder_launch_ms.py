"""Host time a serving batch spends in the encoder's forward
(``wfl.encoder``: launching its kernels, and waiting where a call
synchronises), over the traced job's forwards (``wfl.forward``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.encoder"], "wfl.forward")
