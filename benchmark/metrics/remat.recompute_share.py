"""Share of the card's busy time in the traced training updates spent on
the recompute of checkpointed layers: the device time of what the
program's ``wfl.recompute`` spans launched (on the thread that runs the
backward), over the union of the device's operations in the traced
window, in %. A program without that span reads None."""


def read(run):
    tr = run.get("trace")
    device_s, ops = run.get("device_under", {}).get("wfl.recompute",
                                                    (0.0, 0))
    if not tr or tr["busy_s"] <= 0 or not ops or device_s <= 0:
        return None
    return 100.0 * device_s / tr["busy_s"]
