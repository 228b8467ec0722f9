"""Training traces and step accounting, the port of
``wfl_asr_tpu/utils/profiling.py``:

- :func:`maybe_trace`: a context that records a ``torch.profiler`` trace
  (CPU and, when the card is there, CUDA activities) into
  ``$WFL_PROFILE_DIR/<name>`` when that variable is set — a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``) — and
  prints ``[profile] trace written to <dir>``; it does nothing otherwise;
- :class:`StepTimer`: an EMA of the step time and cumulative audio seconds
  → RTFx, the JAX package's own copy.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_trace(name: str = "wfl"):
    profile_dir = os.environ.get("WFL_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = os.path.join(profile_dir, name)
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, TRACE_FILE))
    print(f"[profile] trace written to {out}")


class StepTimer:
    """EMA step time + cumulative audio-seconds → RTFx."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float = 0.0) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without a matching start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None  # catch unpaired stop() calls
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        self.audio_seconds += audio_seconds
        self.wall_seconds += dt
        return dt

    @property
    def rtfx(self) -> float:
        return self.audio_seconds / self.wall_seconds \
            if self.wall_seconds > 0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else 0.0
