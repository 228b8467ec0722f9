"""Host time an update spends on the segmental metric's BIO decode of
the previous update's predictions (``wfl.host_metric``), over the traced
updates (``wfl.update``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.host_metric"], "wfl.update")
