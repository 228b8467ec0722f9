"""Host time a serving batch spends reading its wavs: each file's read,
resampling and normalisation (``wfl.read_wav``), over the traced job's
forwards (``wfl.forward``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.read_wav"], "wfl.forward")
