"""Spans and counts of the port's stages, recorded where the work runs.

``with span(name, into):`` times its block on the host's clock, and
:func:`record` adds a wait measured between two points that no single
block spans (two threads, or two coroutines). Both add the seconds to a
caller's dict (a job's ``/timings``, a batch handle's stages) and hand
them to each of :data:`OBSERVERS`; the serving layer's metrics
(``serve/metrics.py``) registers its ``ipc_stage_seconds{stage=…}``
histogram there. While a ``torch.profiler`` runs, on any thread, a span
is also a ``record_function`` range of its name, so the trace's clock
puts the program's stages beside the device's kernels. Only leaf stages
are spans: the benchmark names an idle gap of the device by the longest
range open over it. Waits (:func:`record`) are no ranges.

:func:`count` adds to a process-wide total, always on, which
``serve/metrics.py`` renders as the counter of the same name. This
module imports nothing of ``serve/``, so the pipeline layer times and
counts its own stages.
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["OBSERVERS", "count", "record", "span", "total"]

# Callables (stage name, seconds) that every recorded stage is handed to.
OBSERVERS: list = []

_lock = threading.Lock()
_totals: dict[str, float] = {}


def count(name: str, amount: float = 1) -> None:
    """Add ``amount`` to the total ``name``."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + amount


def total(name: str) -> float:
    """The total ``name`` so far (0 before its first count)."""
    with _lock:
        return _totals.get(name, 0)


def record(name: str, seconds: float, into: "dict | None" = None) -> None:
    """Add ``seconds`` to ``into[name]`` (where given) and hand them to
    the observers."""
    if into is not None:
        into[name] = into.get(name, 0.0) + seconds
    for observe in OBSERVERS:
        observe(name, seconds)


class span:
    """``with span(name, into):`` times its block on the host's clock and
    :func:`record` records it; while a profiler runs (on any thread: the
    module flag, not the thread-local one) it is also a
    ``record_function`` range named ``name``. ``end()`` closes it
    early, once; ``seconds`` is its duration once closed."""

    __slots__ = ("name", "into", "t0", "seconds", "_range")

    def __init__(self, name: str, into: "dict | None" = None):
        self.name, self.into, self.seconds = name, into, None
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(name)
            self._range.__enter__()
        self.t0 = time.perf_counter()

    def end(self) -> float:
        if self.seconds is None:
            self.seconds = time.perf_counter() - self.t0
            if self._range is not None:
                self._range.__exit__(None, None, None)
            record(self.name, self.seconds, self.into)
        return self.seconds

    def __enter__(self) -> "span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False
