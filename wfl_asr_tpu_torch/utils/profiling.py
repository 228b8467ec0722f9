"""Traces and spans of the port's host work:

- :func:`maybe_trace`: a context that records a ``torch.profiler`` trace
  (CPU and, when the card is there, CUDA activities) into
  ``$WFL_PROFILE_DIR/<name>`` when that variable is set — a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``) — and
  prints ``[profile] trace written to <dir>``; it does nothing otherwise;
- :func:`span`: a named interval of host work (reading a file, launching
  the encoder, waiting for a readback). It records only while a
  ``torch.profiler`` records in the process (:func:`maybe_trace`'s, or any
  other): then each span is kept in a bounded in-memory buffer
  (:func:`spans`, :func:`reset`) and opens a ``record_function`` range of
  its name, so that it shows in the profiler's trace beside the kernels it
  launched. With no profiler on it does nothing.

The buffer's times are ``time.perf_counter_ns()``; the profiler stamps its
events in Unix nanoseconds. ``record.start_ns + clock_offset_ns()`` puts a
span on the profiler's timeline.

The spans the port opens (one thread launches; the training loader's
producer is a second thread; a backward on the card runs on the autograd
engine's thread, where ``wfl.recompute`` is a root span):

============================  ================================================
``wfl.job``                   one ``infer_folder_batched`` or ``infer_audio``
                              call (a nested call is a child of the outer)
``wfl.list``                  a folder job's listing: each wav's header read
                              and its cache entry looked up (``files``)
``wfl.read_wav``              a file's read, resampling and normalisation
                              (``samples``: the samples it yields)
``wfl.forward``               one serving forward, from assembling its padded
                              rows to the outputs on the device (``rows``;
                              ``samples_true``: Σ the rows' own samples;
                              ``samples_run``: rows × the samples the encoder
                              computes on — the bucket, or Whisper's 30 s;
                              in folder mode ``ahead``: 1 where the rows were
                              read and assembled in the previous forward's
                              shadow, so the span holds only the launch)
``wfl.stage``                 the forward's host-to-device copies (issued
                              without blocking) and its masks
``wfl.shadow``                the host work done while a folder job's forward
                              is in flight, between its encoder's launch and
                              its heads': the previous group's decode and
                              writes, the next group's reads and rows
``wfl.encoder``               the encoder's forward (launches; in training the
                              graph is recorded too)
``wfl.heads``                 language conditioning through the offset head
``wfl.bilstm``                the BiLSTM, inside ``wfl.heads``
``wfl.readback``              a blocking copy of results to the host: the
                              host waits there for the card to finish
``wfl.decode``                the languages' average, gate, median filter and
                              BIO decode of logits into segments: a file's on
                              the host (two spans: the average, the rest), a
                              batch's on the device
``wfl.cache_save``            one ``.wfl_cache`` entry written
``wfl.lab_write``             a ``.lab`` file made and written (merge, forced
                              alignment, write)
``wfl.update``                one optimizer update of the training loop
                              (``step``), with the previous update's readback
                              and log, which the loop does one step late;
                              ``recomputed``: the ``wfl.recompute`` spans
                              opened during its micro-batches (0 without
                              remat)
``wfl.forward_backward``      one micro-batch's forward, losses and backward
                              (``rows``; ``samples_true``: Σ its wavs'
                              samples, or its padded rows' without wavs)
``wfl.recompute``             a checkpointed layer run again inside the
                              backward (``layers.checkpointed`` under
                              ``training.remat``; ``layer``: its index in the
                              encoder), on the thread that runs the backward;
                              the first pass has no span
``wfl.optimizer``             the optimizer's step and ``zero_grad``
``wfl.host_metric``           the segmental metric's BIO decode on the host
``wfl.log``                   the metrics' log line, file and tensorboard
``wfl.loader_wait``           the loop waiting for its next collated batch
``wfl.collate``               a batch collated, on the loader's thread
============================  ================================================
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
BUFFER_SPANS = 1 << 20       # the buffer keeps the newest this many spans


@contextlib.contextmanager
def maybe_trace(name: str = "wfl"):
    profile_dir = os.environ.get("WFL_PROFILE_DIR")
    if not profile_dir:
        yield
        return
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


class SpanRecord(NamedTuple):
    """One span as recorded: ``start_ns``/``end_ns`` on
    ``time.perf_counter_ns()``; ``parent`` the enclosing span on the same
    thread (None for none); ``root`` the outermost enclosing span on the
    thread (the span itself at the top: a job, an update); ``thread``
    ``threading.get_ident()``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int
    attrs: Dict[str, object]


class _Tracer:
    def __init__(self):
        self.records: collections.deque = collections.deque(
            maxlen=BUFFER_SPANS)
        self.ids = itertools.count(1)
        self.local = threading.local()      # .open: this thread's spans
        self.offset_ns: Optional[int] = None
        self.recomputed = 0                 # wfl.recompute spans opened
        self.lock = threading.Lock()


_TRACER = _Tracer()


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapper


class _Noop:
    """What :func:`span` returns while no profiler records: nothing
    happens on entry, exit or :meth:`set`."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def __call__(self, fn):
        return _decorate(self.name, fn)


_NOOPS: Dict[str, _Noop] = {}


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        local = _TRACER.local
        open_ = getattr(local, "open", None)
        if open_ is None:
            open_ = local.open = []
        outer = open_[-1] if open_ else None
        self.id = next(_TRACER.ids)
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        open_.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        _TRACER.offset_ns = time.time_ns() - self.start_ns
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _TRACER.local.open.pop()
        _TRACER.records.append(SpanRecord(
            self.name, self.start_ns, end_ns, self.id, self.parent,
            self.root, threading.get_ident(), self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a file's samples)."""
        self.attrs.update(attrs)

    def __call__(self, fn):
        return _decorate(self.name, fn)


def span(name: str, **attrs):
    """A span of host work named ``name``, with ``attrs`` (counts: rows,
    samples, files) kept beside its times. Use it as a context (``with
    span("wfl.read_wav") as sp: ...; sp.set(samples=n)``) or as a
    decorator (``@span("wfl.job")``: each call is a span, without
    attributes). While no ``torch.profiler`` records in the process it
    costs one check and one lookup and returns a shared no-op.

    The check is the profiler's process-wide flag: a span on a thread the
    profiler does not trace (the loader's) is kept in the buffer all the
    same; only its range is missing from the profiler's trace."""
    if not _autograd_profiler._is_profiler_enabled:
        noop = _NOOPS.get(name)
        return noop if noop is not None else _NOOPS.setdefault(
            name, _Noop(name))
    return _Span(name, attrs)


def recompute(layer: Optional[int]):
    """The ``wfl.recompute`` span of a checkpointed layer's re-run in the
    backward (``layer``: its index), counted by :func:`recomputed`. Like
    :func:`span`, a shared no-op while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return span("wfl.recompute")
    with _TRACER.lock:
        _TRACER.recomputed += 1
    return _Span("wfl.recompute", {"layer": layer})


def recomputed() -> int:
    """The ``wfl.recompute`` spans opened in the process so far (while a
    profiler recorded): the difference of two readings counts the layers
    recomputed between them."""
    return _TRACER.recomputed


def spans() -> List[SpanRecord]:
    """A copy of the buffer: the spans that ended, oldest first."""
    return list(_TRACER.records)


def reset() -> None:
    """Empty the buffer."""
    _TRACER.records.clear()
    _TRACER.offset_ns = None


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, read as the last span
    was recorded (now if none was): add it to a record's times to place
    them on the profiler's (Unix) clock."""
    offset = _TRACER.offset_ns
    return offset if offset is not None else (time.time_ns()
                                              - time.perf_counter_ns())
