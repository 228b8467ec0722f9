"""Reading a ``torch.profiler`` trace of a window on the card.

- busy: the union of the device's operation intervals (kernels, copies,
  sets) in the traced window; the window is the traced host interval;
- the device operations that took most time, by name;
- idle gaps: the device's gaps, each named by the innermost benchmark span
  (``bench.*``) the host was in at the gap's middle;
- device time under a span: the operations launched from host calls that
  lie inside a span's ranges on the same thread (matched to their launch
  by the CUPTI correlation id, or by the enclosing operator's id).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


class Trace:
    def __init__(self, prof, t0_ns: int = None, t1_ns: int = None):
        evs = list(prof.profiler.kineto_results.events())
        # a record_function range (bench.*, Optimizer.step#...) also shows
        # on the device's timeline: a span over kernels, not one
        self.device = [e for e in evs if _is_device(e)
                       and not e.name().startswith("bench.")
                       and "#" not in e.name()
                       and not e.is_user_annotation()
                       and e.duration_ns() > 0]
        self.host = [e for e in evs if not _is_device(e)]
        starts = [e.start_ns() for e in self.host if e.name() == "bench.window"]
        ends = [e.end_ns() for e in self.host if e.name() == "bench.window"]
        self.t0 = t0_ns if t0_ns is not None else (
            min(starts) if starts else min(e.start_ns() for e in evs))
        self.t1 = t1_ns if t1_ns is not None else (
            max(ends) if ends else max(e.end_ns() for e in evs))
        self.device = [e for e in self.device
                       if e.end_ns() > self.t0 and e.start_ns() < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((max(e.start_ns(), self.t0), min(e.end_ns(), self.t1))
                       for e in self.device)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        acc: Dict[str, float] = defaultdict(float)
        for e in self.device:
            acc[e.name()[:120]] += e.duration_ns() / 1e9
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        spans = sorted(((e.start_ns(), e.end_ns(), e.name())
                        for e in self.host if e.name().startswith("bench.")
                        and e.name() != "bench.window"),
                       key=lambda x: x[0])
        acc: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) // 2
            inner = [x for x in spans if x[0] <= mid < x[1]]
            name = (min(inner, key=lambda x: x[1] - x[0])[2] if inner
                    else "outside the benchmark's spans")
            acc[name] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def device_s_under(self, span: str) -> Tuple[float, int]:
        """(device seconds, operations) launched inside ``span``'s ranges."""
        ranges = sorted((e.start_ns(), e.end_ns(), e.start_thread_id())
                        for e in self.host if e.name() == span)
        if not ranges:
            return 0.0, 0
        starts = [r[0] for r in ranges]

        def inside(e) -> bool:
            i = bisect.bisect_right(starts, e.start_ns()) - 1
            # a span's ranges follow one another on a thread: the few last
            # that start before the event are the candidates
            for s, t, thread in ranges[max(i - 3, 0):i + 1]:
                if s <= e.start_ns() < t and thread == e.start_thread_id():
                    return True
            return False

        corr, ops = set(), set()
        for e in self.host:
            if e.name().startswith("bench."):
                if e.name() == span and inside(e):
                    ops.add(e.correlation_id())
                continue
            if inside(e):
                corr.add(e.correlation_id())
                ops.add(e.correlation_id())
        total, count = 0.0, 0
        for e in self.device:
            if (e.correlation_id() in corr
                    or e.linked_correlation_id() in ops):
                total += e.duration_ns() / 1e9
                count += 1
        return total, count


def summarize(trace: Trace) -> dict:
    return {"busy_s": trace.busy_s(), "window_s": trace.window_s,
            "device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}

