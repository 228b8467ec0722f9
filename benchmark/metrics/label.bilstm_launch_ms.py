"""Host time a serving batch spends in the BiLSTM (``wfl.bilstm``, a
part of ``wfl.heads``), over the traced job's forwards (``wfl.forward``),
in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.bilstm"], "wfl.forward")
