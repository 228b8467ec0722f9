"""Spans around the program's calls, recorded from the benchmark's own
files: a named wrapper replaces a function or method for the run and
records each call's host start and end (``time.perf_counter``), its
arguments' shapes where a reader asks for them, and a profiler range of
the same name, so that a trace reader can find the kernels a call
launched."""

from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


def _owner(target: str):
    """"module:attr" or "module:Class.attr" → (the object holding the
    attribute, its name)."""
    mod_name, attr = target.split(":")
    owner = importlib.import_module(mod_name)
    *path, leaf = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, leaf


class Spans:
    def __init__(self):
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, target: str, name: str,
             info: Optional[Callable] = None, static: bool = False) -> None:
        """``target``: "module:attr" or "module:Class.attr". ``info(*args,
        **kwargs)`` → what to keep of a call besides its times."""
        owner, leaf = _owner(target)
        raw = owner.__dict__[leaf] if static else getattr(owner, leaf)
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        calls = self.calls[name]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            extra = info(*args, **kwargs) if info is not None else None
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            calls.append((t0, time.perf_counter(), extra))
            return out

        setattr(owner, leaf, staticmethod(wrapper)
                if isinstance(raw, staticmethod) else wrapper)
        self._undo.append(lambda: setattr(owner, leaf, raw))

    def wrap_iter(self, target: str, name: str) -> None:
        """A generator function: each ``next`` of what it returns is a
        call (the time a consumer waited for the next item)."""
        owner, leaf = _owner(target)
        raw = getattr(owner, leaf)
        calls = self.calls[name]

        @functools.wraps(raw)
        def wrapper(*args, **kwargs):
            it = iter(raw(*args, **kwargs))
            while True:
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                calls.append((t0, time.perf_counter(), None))
                yield item

        setattr(owner, leaf, wrapper)
        self._undo.append(lambda: setattr(owner, leaf, raw))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()
