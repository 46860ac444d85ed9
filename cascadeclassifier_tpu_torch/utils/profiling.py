"""The port's tracer: spans, counters, timed scopes and traces.

Counterpart of ``cascadeclassifier_tpu/utils/profiling.py``. Tracing is
on while a torch profiler is active (``torch.profiler.profile``, or
``trace`` below) and off otherwise; nothing else switches it.

  - ``span(name)``: a scope, named ``<layer>.<phase>``. Off, it is one
    flag check and a shared null context: nothing is recorded and
    nothing synchronizes. On, it opens a ``record_function`` range, so
    the profiler's trace holds it on the kernels' clock, and keeps a
    ``Span``: its name, id, parent and root ids (the spans of one frame
    or one job share its root), host start and end
    (``perf_counter_ns``), the counts made while it was open, and on a
    CUDA device an event on the current stream at each end, resolved
    into ``device_s`` only when it is read.
  - ``span(name, timings=d)``: besides, traced or not, synchronizes the
    device at the scope's end and adds its wall milliseconds to the dict
    d under the name's last part (``Engine.detect(timings=)``).
  - ``count(name, n=1)``: adds n to every open span's counts and to
    ``counters()``; off, nothing. ``count(SYNC)`` marks each site of the
    detection and training paths where the host waits for the card: a
    fetch, a Python number or ``bool`` of a device tensor,
    ``torch.nonzero``, a boolean-mask index, a blocking upload. A site
    counts whatever the device, so a CPU run counts the waits a CUDA run
    makes.
  - ``spans()``, ``counters()`` and ``reset()`` read and clear the
    record.
  - ``timed(name)``: a span that also, always, synchronizes the device at
    both ends and appends its wall seconds to a registry (``timings``,
    ``summary``, cleared by ``reset_timings``) under the name's last
    part. Only scopes with readers are timed: the trainer's fills,
    ``set_samples`` and ``train_stage``.
  - ``trace(log_dir)``: ``torch.profiler`` over a scope, written as a
    Chrome trace into log_dir (the JAX profiler's trace there); the
    program's spans are in it as ``user_annotation`` events.

The record is the process's own and is meant for one thread.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import Counter, defaultdict

import torch
import torch.autograd.profiler as _profiler

SYNC = "sync"

_TIMINGS: dict = defaultdict(list)
_SPANS: list = []
_OPEN: list = []
_COUNTERS: Counter = Counter()
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


class Span:
    """One traced scope; ``t1_ns`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "root", "t0_ns", "t1_ns", "counts", "_events",
                 "_stream")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_IDS)
        self.parent = _OPEN[-1].id if _OPEN else None
        self.root = _OPEN[0].id if _OPEN else self.id
        self.counts = {}
        self.t1_ns = None
        self._events = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # both ends on the stream current at entry; looking it up costs
            # as much as recording an event
            self._stream = torch.cuda.current_stream()
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.t0_ns = time.perf_counter_ns()

    def close(self):
        if self._events is not None:
            self._events[1].record(self._stream)
        self.t1_ns = time.perf_counter_ns()

    @property
    def device_s(self):
        """Seconds between the span's two events on the stream's timeline
        (waits for the second one), or None off a CUDA device."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


class _Scope:
    def __init__(self, name: str, timings: dict | None):
        self.name, self.timings = name, timings
        self.span = self.range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            self.span = Span(self.name)
            _SPANS.append(self.span)
            _OPEN.append(self.span)
        self.t0 = time.perf_counter()
        return self.span

    def __exit__(self, *exc):
        if self.timings is not None:
            _sync()
            key = self.name.rsplit(".", 1)[-1]
            self.timings[key] = self.timings.get(key, 0.0) + (time.perf_counter() - self.t0) * 1e3
        if self.span is not None:
            self.span.close()
            _OPEN.remove(self.span)
            self.range.__exit__(*exc)
        return False


def span(name: str, timings: dict | None = None):
    """A traced scope (see the module docstring); with ``timings``, also
    the synchronized wall ms of the scope added to it."""
    if timings is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Scope(name, timings)


def count(name: str, n: int = 1):
    """Add n to every open span's counts and to counters(), when tracing."""
    if not _profiler._is_profiler_enabled:
        return
    _COUNTERS[name] += n
    for s in _OPEN:
        s.counts[name] = s.counts.get(name, 0) + n


def spans() -> list:
    """Every span recorded since the last reset(), in the order opened."""
    return list(_SPANS)


def counters() -> dict:
    """Every count made since the last reset()."""
    return dict(_COUNTERS)


def reset():
    """Forget the recorded spans and counts (the timed registry stays)."""
    _SPANS.clear()
    _COUNTERS.clear()


def timings() -> dict:
    """All collected {scope: [seconds, ...]} so far."""
    return dict(_TIMINGS)


def reset_timings():
    _TIMINGS.clear()


def _sync():
    """Wait for the card, when one is in use: a sync site."""
    count(SYNC)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str):
    """A span whose wall seconds, with the device synchronized at both
    ends, are appended to the registry under the name's last part."""
    _sync()
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _sync()
        _TIMINGS[name.rsplit(".", 1)[-1]].append(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the scope (CPU activity, and CUDA activity when
    a card is present), written on exit as a Chrome trace
    ``<host>_<pid>.<time>.pt.trace.json`` into log_dir; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
        yield p


def summary() -> str:
    """One line a timed scope: its count, total and mean seconds."""
    lines = []
    for name, vals in sorted(_TIMINGS.items()):
        total = sum(vals)
        lines.append(
            f"{name:40s} n={len(vals):4d} total={total:8.3f}s "
            f"mean={total / len(vals):8.4f}s"
        )
    return "\n".join(lines)
