"""Host time a batch of the folder path spends outside the forward: each
window job's wall time less the time inside
``InferenceSession.forward_many`` (file reading, host decode, cache and
``.lab`` writes, all serialised with the card), over the job's
batches."""


def read(run):
    calls = run["spans"].calls.get("bench.forward_many", [])
    outside, batches = 0.0, 0
    for _j, _k, t0, t1, _out, _cache in run["window_jobs"]:
        inside = [c for c in calls if t0 <= c[0] < t1]
        outside += (t1 - t0) - sum(c[1] - c[0] for c in inside)
        batches += len(inside)
    return 1e3 * outside / batches if batches else None
