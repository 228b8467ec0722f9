"""Share of the samples the serving encoder computes on that are padding,
over the traced job's forwards: 100 × (1 − Σ ``samples_true`` / Σ
``samples_run``) of ``wfl.forward`` (rows × the bucket, or Whisper's 30 s
rows), in %."""

from benchmark.metrics._program_spans import traced


def read(run):
    spans = traced(run)
    forwards = spans.get("wfl.forward", ()) if spans else ()
    run_samples = sum(r.attrs["samples_run"] for r in forwards)
    if not run_samples:
        return None
    true_samples = sum(r.attrs["samples_true"] for r in forwards)
    return 100.0 * (1.0 - true_samples / run_samples)
