"""The ``whisper-large-v3.train_remat`` cell at a tiny size on the CPU
(the tiny copy of ``tiny.py`` with this cell's configuration and traffic
added in memory: large-v3's 128 mel bins and config.yaml's heads at a
width of 32, ``train_remat``'s recipe at ``tiny.py``'s sizes), its driver
``train_remat`` and its four readers.

- Untraced and traced runs are ``correct``; the traced one reads every
  metric of the cell: the host-clock and counter readings here, the two
  device readings (``remat.recompute_share``, ``attn_wide_bwd_roofline``)
  nothing, since the CPU runs no kernel, though the recompute's spans are
  in the traced window. What the driver swapped is put back.
- The same traced cell through ``train_corpus``, whose wrapper reads the
  attention backwards' saved tensors a second time, stops with
  ``CheckpointError``: why the driver exists.
- The device readers on synthetic runs with known sums, and None on a run
  without the new spans (an older program) or without a trace.
"""

import json
import os

import pytest
import torch

from benchmark import run as brun
from benchmark.core.spans import Spans
from benchmark.drivers import train_corpus
from benchmark.metrics._program_spans import traced
from benchmark.tests import tiny
from benchmark.tests.test_bench_program_spans import reader

CELL = "whisper-large-v3.train_remat"
NEW = ["remat.recompute_share", "attn_wide_bwd_roofline", "mfu.train_remat",
       "peak_gib.train_remat"]
LAYERS = 2


def _write(bdir, traffic_driver):
    cfg = tiny._load("configs", "whisper-large-v3.json")
    cfg.update(d_model=32, encoder_layers=LAYERS, encoder_attention_heads=2,
               encoder_ffn_dim=64)
    cfg["heads"] = dict(cfg["heads"], lang_emb_dim=8)
    with open(os.path.join(bdir, "configs", "whisper-large-v3.json"),
              "w") as f:
        json.dump(cfg, f)
    tr = dict(tiny.tiny_traffic()["train_mixed"], driver=traffic_driver)
    tr["training"] = dict(tr["training"], remat=True)
    assert tr["training"] == dict(tiny._load(
        "traffic", "train_remat.json")["training"], batch_size=4)
    with open(os.path.join(bdir, "traffic", "train_remat.json"), "w") as f:
        json.dump(tr, f)


@pytest.fixture(scope="module")
def remat_bench(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_remat"))
    bdir = tiny.layout(root)
    _write(bdir, "train_remat")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f), bdir


def _run(bench, bdir, trace, monkeypatch=None, seed=2 ** 33 + 5):
    """run.py's run of the cell; with ``monkeypatch``, also the driver's
    run dict."""
    kept = {}
    if monkeypatch is not None:
        real = brun._load_module

        def load(path, name):
            mod = real(path, name)
            if name.startswith("bench_driver_"):
                run = mod.run

                def keep(ctx):
                    kept["run"] = run(ctx)
                    return kept["run"]
                mod.run = keep
            return mod
        monkeypatch.setattr(brun, "_load_module", load)
    out = brun.run_cell(bench, CELL, seed, 1.0, trace, device="cpu",
                        bench_dir=bdir)
    return out, kept.get("run")


def test_the_cell_is_listed(remat_bench):
    bench, _ = remat_bench
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "whisper-large-v3", "train_remat", 1)
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "train_audio_s_per_s")
    assert CELL in rate["workloads"]
    mine = [m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", [CELL])]
    assert mine == NEW


def test_untraced_run(remat_bench):
    out, _ = _run(*remat_bench, False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_audio_s_per_s", "setup_s"}


def test_traced_run(remat_bench, monkeypatch):
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as FA
    before = (FA.launch_backward, FA._launch_wide,
              train_corpus._install_spans, train_corpus.Trace)
    out, run = _run(*remat_bench, True, monkeypatch)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    assert got == {"mfu.train_remat", "peak_gib.train_remat"}
    assert out["metrics"]["mfu.train_remat"]["value"] > 0
    assert (FA.launch_backward, FA._launch_wide, train_corpus._install_spans,
            train_corpus.Trace) == before
    # the CPU runs the plain twins: the recompute's spans are there, with
    # no device time under them, and no launcher was called
    spans = traced(run)
    updates = spans["wfl.update"]
    assert len(updates) == 1 and updates[0].attrs["recomputed"] == LAYERS
    assert sorted(r.attrs["layer"] for r in spans["wfl.recompute"]) == \
        list(range(LAYERS))
    assert run["device_under"]["wfl.recompute"] == (0.0, 0)
    assert run["device_under"]["bench.attn_wide_bwd"] == (0.0, 0)
    assert not run["spans"].calls["bench.attn_wide_bwd"]
    for name in NEW[:2]:
        assert reader(name)(run) is None


def test_train_corpus_cannot_trace_remat(tmp_path):
    from torch.utils.checkpoint import CheckpointError
    bdir = tiny.layout(str(tmp_path))
    _write(bdir, "train_corpus")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    with pytest.raises(CheckpointError, match="already unpacked once"):
        _run(bench, bdir, True)


T0 = 1000.0


def _trace_run(busy_s=2.0, under=None, wide_calls=()):
    spans = Spans()
    spans.calls["bench.attn_wide_bwd"].extend(wide_calls)
    return {"trace": {"busy_s": busy_s, "window_s": 4.0},
            "trace_host": (T0, T0 + 10.0), "spans": spans,
            "device_under": dict(under or {})}


def test_recompute_share():
    read = reader("remat.recompute_share")
    run = _trace_run(under={"wfl.recompute": (0.5, 640)})
    assert read(run) == pytest.approx(25.0)
    # an older program: no wfl.recompute span, nothing under it
    assert read(_trace_run(under={"wfl.recompute": (0.0, 0)})) is None
    assert read(_trace_run()) is None
    assert read({"e2e": {}}) is None


def test_wide_backward_roofline():
    from benchmark.metrics._common import attention_bwd_bound
    read = reader("attn_wide_bwd_roofline")
    kv = torch.tensor([1500] * 12 + [700] * 4, dtype=torch.int32)
    info = ((16, 2, 1500, 640), torch.float32, False, kv)
    calls = [(T0 + 1.0, T0 + 1.1, info), (T0 + 2.0, T0 + 2.1, info),
             (T0 + 20.0, T0 + 20.1, info)]     # the last outside the window
    bound = attention_bwd_bound(info)
    # twice the kernel table's 1.40 ms bound at 8 rows with every key
    # valid, less the invalid keys
    assert 2.0e-3 < bound < 2.8e-3
    run = _trace_run(under={"bench.attn_wide_bwd": (10 * bound, 6)},
                     wide_calls=calls)
    assert read(run) == pytest.approx(100.0 * 2 / 10)
    assert read(_trace_run(wide_calls=calls)) is None
    assert read(_trace_run(under={"bench.attn_wide_bwd": (1.0, 3)})) is None
    assert read({"e2e": {}}) is None


def test_host_readers_read_as_the_accepted_ones():
    run = {"cfg": tiny._load("configs", "whisper-large-v3.json"),
           "num_labels": 73, "num_params": 780_000_000,
           "window_updates": [[(160_000, 500), (480_000, 1500)]] * 3,
           "window_s": 12.5, "device": {"memory_peak_bytes": 37 * 2 ** 30}}
    assert reader("mfu.train_remat")(run) == reader("mfu.train")(run) > 0
    assert reader("peak_gib.train_remat")(run) == 37.0

