"""Host time an update spends in the optimizer's step and ``zero_grad``
(``wfl.optimizer``), over the traced updates (``wfl.update``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.optimizer"], "wfl.update")
