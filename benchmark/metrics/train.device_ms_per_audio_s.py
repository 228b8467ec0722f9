"""Device time a second of trained audio costs: the traced updates' busy
seconds on the card (the union of their operations) over the real seconds
of audio in their batches, in ms. It leaves out the host's share, which
the end-to-end rate carries."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0 or not run.get("trace_audio_s"):
        return None
    return 1e3 * tr["busy_s"] / run["trace_audio_s"]
