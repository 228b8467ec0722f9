"""Mean time an update of the window waits on the training loader: the
host time inside the ``next`` of ``BatchLoader.epoch_batches`` between the
window's updates, over the window's updates."""


def read(run):
    t0, t1 = run["window_host"]
    waits = [c[1] - c[0] for c in run["spans"].calls.get("bench.loader_next",
                                                          ())
             if t0 <= c[0] < t1]
    n = len(run["window_updates"])
    return 1e3 * sum(waits) / n if n else None
