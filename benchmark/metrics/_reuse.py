"""An accepted reader's arithmetic under another metric's name: a cell
that reports another end-to-end metric, or is listed under a metric of its
own, reads the same quantity with the same file."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    """The ``read`` of ``benchmark/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_reused_" + name.replace(".", "_"),
        os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
