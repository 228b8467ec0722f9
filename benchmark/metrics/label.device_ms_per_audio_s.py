"""Device time a second of labelled audio costs: the traced job's busy
seconds on the card (the union of its operations) over the seconds of
audio in its folder, in ms. It leaves out the host's share, which the
end-to-end rate carries and which varies with the host from run to run."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0 or not run.get("trace_audio_s"):
        return None
    return 1e3 * tr["busy_s"] / run["trace_audio_s"]
