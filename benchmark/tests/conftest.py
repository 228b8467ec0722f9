import json
import os

import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """(BENCHMARK dict, benchmark dir) of the tiny copy."""
    root = str(tmp_path_factory.mktemp("tiny"))
    bdir = tiny.layout(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f), bdir


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device (decided here, at run
    time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
