"""Host time a serving batch waits in blocking copies of the forward's
results to the host (``wfl.readback``): the card finishing what the host
launched, over the traced job's forwards (``wfl.forward``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.readback"], "wfl.forward")
