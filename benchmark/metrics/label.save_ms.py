"""Host time a serving batch spends writing its outputs: the
``.wfl_cache`` entries (``wfl.cache_save``) and the ``.lab`` files
(``wfl.lab_write``), over the traced job's forwards (``wfl.forward``), in
ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.cache_save", "wfl.lab_write"], "wfl.forward")
