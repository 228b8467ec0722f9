"""Host time an update waits on the one-step-late readback of the losses
(``wfl.readback``: the card finishing the work queued so far), over the
traced updates (``wfl.update``), in ms."""

from benchmark.metrics._program_spans import ms_per


def read(run):
    return ms_per(run, ["wfl.readback"], "wfl.update")
