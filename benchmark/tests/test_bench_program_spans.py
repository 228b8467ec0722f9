"""The readers of the program's own spans (``benchmark/metrics/``, through
``_program_spans``) on synthetic span lists with known sums, None where
their spans are absent or the program keeps none, and a traced tiny run
of a serving and a training cell on the CPU that reports every one."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from benchmark import run as brun

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")
LABEL = ["label.read_ms", "label.decode_ms", "label.save_ms",
         "label.padding_share", "label.encoder_launch_ms",
         "label.heads_launch_ms", "label.bilstm_launch_ms",
         "label.readback_wait_ms"]
TRAIN = ["train.launch_ms", "train.optimizer_ms", "train.readback_wait_ms",
         "train.host_metric_ms"]
MS = 1_000_000
T0 = 1_000 * 10 ** 9                  # the traced window: 1000 s to 1010 s


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "t_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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


RUN = {"trace_host": (T0 / 1e9, T0 / 1e9 + 10.0)}

SERVING = [
    # two forwards in the window; one span before it, one after
    rec("wfl.forward", 10, 100, rows=4, samples_true=300, samples_run=400),
    rec("wfl.forward", 300, 100, rows=2, samples_true=100, samples_run=200),
    rec("wfl.read_wav", 1, 3, samples=10), rec("wfl.read_wav", 5, 5),
    rec("wfl.decode", 120, 7), rec("wfl.cache_save", 130, 2),
    rec("wfl.cache_save", 133, 4), rec("wfl.lab_write", 140, 6),
    rec("wfl.encoder", 20, 30), rec("wfl.encoder", 310, 10),
    rec("wfl.heads", 60, 40), rec("wfl.bilstm", 61, 20),
    rec("wfl.readback", 111, 9),
    rec("wfl.read_wav", -50, 1000), rec("wfl.read_wav", 10_001, 1000),
    rec("wfl.forward", 10_500, 5, rows=1, samples_true=1, samples_run=9),
]
TRAINING = [
    rec("wfl.update", 0, 500, step=4), rec("wfl.update", 500, 500, step=5),
    rec("wfl.forward_backward", 10, 300), rec("wfl.forward_backward", 510,
                                              200),
    rec("wfl.optimizer", 320, 40), rec("wfl.optimizer", 720, 20),
    rec("wfl.readback", 400, 11), rec("wfl.readback", 800, 13),
    rec("wfl.host_metric", 420, 30),
    rec("wfl.optimizer", -400, 1000),
]


@pytest.mark.parametrize("name,want", [
    ("label.read_ms", 8 / 2), ("label.decode_ms", 7 / 2),
    ("label.save_ms", 12 / 2), ("label.padding_share", 100 * (1 - 400 / 600)),
    ("label.encoder_launch_ms", 40 / 2), ("label.heads_launch_ms", 40 / 2),
    ("label.bilstm_launch_ms", 20 / 2), ("label.readback_wait_ms", 9 / 2)])
def test_serving_readers(with_spans, name, want):
    with_spans(SERVING)
    assert reader(name)(RUN) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("train.launch_ms", 500 / 2), ("train.optimizer_ms", 60 / 2),
    ("train.readback_wait_ms", 24 / 2), ("train.host_metric_ms", 30 / 2)])
def test_training_readers(with_spans, name, want):
    with_spans(TRAINING)
    assert reader(name)(RUN) == pytest.approx(want)


@pytest.mark.parametrize("name", LABEL + TRAIN)
def test_none_without_their_spans(with_spans, monkeypatch, name):
    """None: no span of the kind, no span in the window, no traced window,
    and a program without ``spans`` (an older one)."""
    other = TRAINING if name in LABEL else SERVING
    with_spans(other)
    assert reader(name)(RUN) is None
    with_spans([rec(r.name, r.start_ns // MS, 1, **r.attrs)
                for r in SERVING + TRAINING])   # all long after the window
    assert reader(name)(RUN) is None
    with_spans(SERVING + TRAINING)
    assert reader(name)({}) is None
    from wfl_asr_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert reader(name)(RUN) is None


@pytest.mark.parametrize("workload,names", [
    ("wavlm-base-plus.label_mixed", LABEL),
    ("whisper-base.train_mixed", TRAIN)])
def test_a_traced_tiny_run_reports_them(tiny_bench, workload, names):
    bench, bdir = tiny_bench
    out = brun.run_cell(bench, workload, 2 ** 31 + 7, 1.0, True,
                        device="cpu", bench_dir=bdir)
    assert out["correct"], out["checks"]
    for name in names:
        assert out["metrics"][name]["value"] >= 0, name
    assert not any(n.startswith("wfl.")
                   for n, _s in out["breakdown"]["device_ops"])
