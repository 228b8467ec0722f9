"""Host time a serving batch spends decoding its files' logits into
segments: the languages' average, gate, median filter and BIO decode
(``wfl.decode``), over the traced job's forwards (``wfl.forward``), in
ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.decode"], "wfl.forward")
