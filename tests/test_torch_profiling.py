"""The port's ``utils/profiling.maybe_trace`` on the CPU: a no-op without
``WFL_PROFILE_DIR`` and a ``torch.profiler`` trace with it (the JAX
package's printed line), and the train loop's ``train`` trace. Its spans:
``tests/test_torch_tracing.py``.

    python -m pytest tests/test_torch_profiling.py -q
"""

import json
import os

import torch

from wfl_asr_tpu_torch.utils import profiling as TP


def test_maybe_trace_noop(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("WFL_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with TP.maybe_trace("x"):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
    assert capsys.readouterr().out == ""


def test_maybe_trace_writes_a_trace(monkeypatch, tmp_path, capsys):
    """With WFL_PROFILE_DIR set, a Chrome trace of the block's torch ops
    under $WFL_PROFILE_DIR/<name>, and the JAX module's printed line."""
    monkeypatch.setenv("WFL_PROFILE_DIR", str(tmp_path))
    with TP.maybe_trace("probe"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    out = tmp_path / "probe"
    assert capsys.readouterr().out == f"[profile] trace written to {out}\n"
    events = json.loads((out / TP.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_train_loop_runs_inside_the_trace(monkeypatch, tmp_path):
    """The train loop's updates run inside maybe_trace("train") (JAX
    loop.py:1127-1129, 1266): the trace holds the optimizer's steps and
    the program's update spans."""
    from tests.test_torch_train import make_config, make_data
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop as TLOOP
    root = str(tmp_path)
    make_data(root, n_per_lang=3)
    cfg = make_config(root, max_steps=2, val_check_interval=2,
                      optimizer="Lamb", learning_rate=1e-3)
    preprocess(cfg["data"]["data_dir"], cfg)
    cfg["model"]["num_languages"] = 2
    monkeypatch.setenv("WFL_PROFILE_DIR", str(tmp_path / "prof"))
    torch.set_num_threads(2)
    TLOOP.train(cfg, device="cpu")
    trace = tmp_path / "prof" / "train" / TP.TRACE_FILE
    names = {e.get("name") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert "Optimizer.step#Lamb.step" in names
    assert {"wfl.update", "wfl.forward_backward", "wfl.optimizer"} <= names
    assert any(n and n.startswith("aten::_foreach_") for n in names)
