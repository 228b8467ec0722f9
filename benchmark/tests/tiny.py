"""A tiny copy of the benchmark for CPU tests: narrow configurations of
both encoders, small traffic mixes, and a BENCHMARK dict over them, laid
out as ``<root>/benchmark/{configs,traffic,checks}`` beside the real
drivers and metric readers."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_configs() -> dict:
    w = _load("configs", "wavlm-base-plus.json")
    w.update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64, conv_dim=[16] * 7)
    s = _load("configs", "whisper-base.json")
    s.update(d_model=32, encoder_layers=2, encoder_attention_heads=2,
             encoder_ffn_dim=64)
    for c in (w, s):
        c["heads"] = dict(c["heads"], lang_emb_dim=8)
    return {"wavlm-base-plus": w, "whisper-base": s}


def tiny_traffic() -> dict:
    label = _load("traffic", "label_mixed.json")
    label.update(folders=2, files_per_folder=4, batch_files=2,
                 duration_s=dict(label["duration_s"], median=1.5, max=3.0),
                 check=dict(files=3, with_longest=True))
    train = _load("traffic", "train_mixed.json")
    train.update(files_per_language=6, num_val_files=2,
                 duration_s=dict(train["duration_s"], median=1.5, max=3.0),
                 training=dict(train["training"], batch_size=4),
                 trace_updates=1)
    return {"label_mixed": label, "train_mixed": train}


def layout(root: str, limits: dict = None) -> str:
    """Write the tiny benchmark under ``root``; returns its benchmark
    directory. ``limits``: {workload: {name: limit}} over the real
    files' (which are for the full sizes)."""
    bench = copy.deepcopy(_load("..", "BENCHMARK.json"))
    bdir = os.path.join(root, "benchmark")
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(bdir, sub), exist_ok=True)
    for sub in ("drivers", "metrics"):
        os.symlink(os.path.join(BENCH, sub), os.path.join(bdir, sub))
    for name, cfg in tiny_configs().items():
        with open(os.path.join(bdir, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
    for name, tr in tiny_traffic().items():
        with open(os.path.join(bdir, "traffic", name + ".json"), "w") as f:
            json.dump(tr, f)
    for w in bench["workloads"]:
        lim = _load("checks", w["name"] + ".json")
        lim["limits"].update((limits or {}).get(w["name"], {}))
        with open(os.path.join(bdir, "checks", w["name"] + ".json"),
                  "w") as f:
            json.dump(lim, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bdir
