"""Host time a serving batch spends in the heads, language conditioning
through the offset head, the BiLSTM included (``wfl.heads``), over the
traced job's forwards (``wfl.forward``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.heads"], "wfl.forward")
