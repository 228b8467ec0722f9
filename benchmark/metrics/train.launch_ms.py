"""Host time an update spends in its micro-batches' forward, losses and
backward (``wfl.forward_backward``), over the traced updates
(``wfl.update``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.forward_backward"], "wfl.update")
