"""``run.py``'s control flow at a tiny size on the CPU: each cell's set-up,
window, traced window and output check, with the program on its plain
path (the port runs its kernels' plain twins on the CPU), and the result
line's format. No number of these runs is a device number."""

import json

import pytest

from benchmark import run as brun

CELLS = ["wavlm-base-plus.label_mixed", "whisper-base.label_mixed",
         "whisper-base.train_mixed"]


def _run(tiny_bench, workload, trace, seed=2 ** 31 + 99):
    bench, bdir = tiny_bench
    return brun.run_cell(bench, workload, seed, 1.0, trace, device="cpu",
                         bench_dir=bdir)


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_and_is_correct(tiny_bench, workload):
    out = _run(tiny_bench, workload, False)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    rate = ("label_audio_s_per_s" if "label" in workload
            else "train_audio_s_per_s")
    assert set(out["metrics"]) == {rate, "setup_s"}
    # a job on a loaded CPU can outlast the 1 s window: its answers are
    # judged all the same, and count 0 towards the rate
    assert out["metrics"][rate]["value"] >= 0


@pytest.mark.parametrize("workload", [CELLS[0], CELLS[2]])
def test_a_traced_cell_reports_its_layers(tiny_bench, workload):
    out = _run(tiny_bench, workload, True)
    assert out["correct"], out["checks"]
    bench, _ = tiny_bench
    want = {m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])}
    # the CPU runs no kernel: the rooflines find nothing to read
    got = set(out["metrics"])
    assert got <= want
    assert not any(n.endswith("_roofline") for n in got)
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_the_result_line(tiny_bench):
    out = _run(tiny_bench, CELLS[1], False)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert brun.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
