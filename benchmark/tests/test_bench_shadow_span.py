"""The reader of ``label.shadow_ms`` (the program's ``wfl.shadow`` spans
over its ``wfl.forward`` spans) on synthetic span lists with known sums,
None where the spans are absent or the program keeps none, and a traced
tiny run of each serving cell on the CPU that reports it."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from benchmark import run as brun

READER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics", "label.shadow_ms.py")
MS = 1_000_000
T0 = 2_000 * 10 ** 9                  # the traced window: 2000 s to 2010 s
RUN = {"trace_host": (T0 / 1e9, T0 / 1e9 + 10.0)}


def read(run):
    spec = importlib.util.spec_from_file_location("t_label_shadow_ms",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def rec(name, start_ms, dur_ms, **attrs):
    s = T0 + start_ms * MS
    return SimpleNamespace(name=name, start_ns=s, end_ns=s + dur_ms * MS,
                           attrs=attrs)


@pytest.fixture
def with_spans(monkeypatch):
    """Makes the program's ``spans()`` return the given list."""
    from wfl_asr_tpu_torch.utils import profiling

    def put(records):
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return put


# a job of three groups: the first forward's shadow reads the second group,
# the last one's writes the second; one shadow after the window
FORWARDS = [rec("wfl.forward", 10, 50, rows=4, samples_true=3,
                samples_run=4, ahead=0),
            rec("wfl.forward", 200, 40, rows=4, samples_true=3,
                samples_run=4, ahead=1),
            rec("wfl.forward", 400, 30, rows=2, samples_true=1,
                samples_run=2, ahead=1)]
SHADOWS = [rec("wfl.shadow", 60, 90), rec("wfl.shadow", 240, 120),
           rec("wfl.shadow", 430, 60), rec("wfl.shadow", 10_300, 500)]


def test_reads_the_shadows_over_the_forwards(with_spans):
    with_spans(FORWARDS + SHADOWS + [rec("wfl.readback", 160, 20)])
    assert read(RUN) == pytest.approx((90 + 120 + 60) / 3)


def test_a_job_of_one_group_has_none(with_spans):
    """One group has nothing to overlap: no shadow, so None."""
    with_spans(FORWARDS[:1] + [rec("wfl.readback", 60, 20)])
    assert read(RUN) is None


def test_none_without_the_spans(with_spans, monkeypatch):
    """None: an older program's spans (forwards, no shadows), every span
    after the window, no traced window, and a program without ``spans``."""
    with_spans([SimpleNamespace(**dict(vars(r), attrs={
        k: v for k, v in r.attrs.items() if k != "ahead"}))
        for r in FORWARDS])
    assert read(RUN) is None
    with_spans([rec(r.name, r.start_ns // MS, 1, **r.attrs)
                for r in FORWARDS + SHADOWS])
    assert read(RUN) is None
    with_spans(FORWARDS + SHADOWS)
    assert read({}) is None
    from wfl_asr_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert read(RUN) is None


@pytest.mark.parametrize("workload", ["wavlm-base-plus.label_mixed",
                                      "whisper-base.label_mixed"])
def test_a_traced_tiny_run_reports_it(tiny_bench, workload):
    bench, bdir = tiny_bench
    out = brun.run_cell(bench, workload, 2 ** 31 + 11, 1.0, True,
                        device="cpu", bench_dir=bdir)
    assert out["correct"], out["checks"]
    assert out["metrics"]["label.shadow_ms"]["value"] > 0
