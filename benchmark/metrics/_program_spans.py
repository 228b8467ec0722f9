"""The program's own spans (``wfl_asr_tpu_torch.utils.profiling``, kept
while the profiler records) that started inside the traced host
interval. A program that keeps none, as an older one, yields None, and
so does every metric that reads them."""

from __future__ import annotations

from collections import defaultdict


def traced(run):
    """{span name: [records]} of the spans that started inside
    ``run["trace_host"]`` (seconds on ``time.perf_counter``, the clock of
    the records' nanoseconds); None without a traced window or spans."""
    try:
        from wfl_asr_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None or "trace_host" not in run:
        return None
    t0, t1 = run["trace_host"]
    lo, hi = round(t0 * 1e9), round(t1 * 1e9)
    out = defaultdict(list)
    for r in read():
        if lo <= r.start_ns < hi:
            out[r.name].append(r)
    return out or None


def ms_per(run, names, per: str):
    """Σ duration of the spans named ``names``, in ms, over the count of
    the spans named ``per`` (a forward, an update); None where either is
    missing."""
    spans = traced(run)
    if spans is None:
        return None
    found = [r for name in names for r in spans.get(name, ())]
    count = len(spans.get(per, ()))
    if not found or not count:
        return None
    return sum(r.end_ns - r.start_ns for r in found) / 1e6 / count
