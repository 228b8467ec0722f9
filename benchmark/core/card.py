"""What both drivers do around the program: the set-up split, the card's
start (CUDA context, the kernels built once into the checkout and loaded),
the synchronize, the host's clocks over the window, the ``device`` entry
of the result line, and the reference model over seeded weights."""

from __future__ import annotations

import os
import resource
import time

import torch

from ..reference.tagger import Tagger, weight_spec


class Laps:
    """The set-up split: seconds since the previous lap, by name."""

    def __init__(self, t_start: float):
        self.split, self.mark = {}, t_start

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.split[name] = now - self.mark
        self.mark = now


def sync(device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def start(device, laps: Laps) -> None:
    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        sync(device)
    laps("cuda_init_s")
    if device == "cuda":
        from wfl_asr_tpu_torch.ops.kernels import _build
        _build.build_all(sorted(_build.SIGNATURES))
        for name in sorted(_build.SIGNATURES):
            _build.library(name)
    laps("kernels_s")


def host_clock() -> dict:
    """The process's wall and CPU seconds (every thread) and its context
    switches: waiting for a core (involuntary) or for I/O and the card
    (voluntary)."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(), "cpu_s": time.process_time(),
            "involuntary_switches": r.ru_nivcsw,
            "voluntary_switches": r.ru_nvcsw,
            "fs_writes_512b": r.ru_oublock}


def host_delta(a: dict, b: dict) -> dict:
    """What the host did between two :func:`host_clock` readings, with the
    process's intra-op threads and the cores it may run on."""
    out = {k: b[k] - a[k] for k in a}
    out["threads"] = torch.get_num_threads()
    out["cores"] = len(os.sched_getaffinity(0))
    return out


def device_info(device, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def spec_for(cfg: dict):
    with torch.device("meta"):
        model = Tagger(cfg, cfg["assumed"]["num_labels"],
                       cfg["assumed"]["num_languages"])
    return weight_spec(model)


def reference_model(cfg: dict, state, device, dtype=torch.float32):
    ref = Tagger(cfg, cfg["assumed"]["num_labels"],
                 cfg["assumed"]["num_languages"]).to(device)
    ref.load_state_dict(state)
    return ref.to(dtype).eval()
