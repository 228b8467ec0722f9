"""Host time a serving batch spends in the shadow of a forward in flight
(``wfl.shadow``: the previous group's decode and writes and the next
group's reads and row assembly, done between the forward's launch and its
readback), over the traced job's forwards (``wfl.forward``), in ms. None
from a program that keeps no such span."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.shadow"], "wfl.forward")
