"""The control comes out as not correct: the plain reference in bfloat16
(the precision below the configurations' float32 with TF32 products
allowed) in the program's place reads above the committed limits of each
cell, here at a tiny size on the CPU (on the card at the cells' own size:
``calibrate.py --control-seeds``)."""

import json
import os

import pytest

from benchmark.drivers import label_folders, train_corpus
from benchmark.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))


def _limits(workload):
    with open(os.path.join(HERE, "..", "checks", workload + ".json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("workload", ["wavlm-base-plus.label_mixed",
                                      "whisper-base.label_mixed",
                                      "whisper-base.train_mixed"])
def test_the_control_fails(tmp_path, workload):
    encoder, kind = workload.split(".")
    driver = label_folders if kind == "label_mixed" else train_corpus
    cfg = tiny.tiny_configs()[encoder]
    tr = tiny.tiny_traffic()[kind]
    limits = _limits(workload)
    for seed in (3, 4, 5):
        readings = driver.control(cfg, tr, seed, "cpu",
                                  str(tmp_path / str(seed)))
        over = [n for n, lim in limits.items() if readings[n] > lim]
        assert over, (seed, readings, limits)
