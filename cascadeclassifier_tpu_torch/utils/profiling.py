"""Phase timers and traces.

Counterpart of ``cascadeclassifier_tpu/utils/profiling.py``:

  - ``timed(name)`` appends a scope's seconds to a global registry
    (``timings``, ``summary``). When a CUDA device is initialised, the
    scope synchronizes it at its start and end, so a phase time
    (``fill_negatives``, ``mine_values``, ``train_stage``, …) holds the
    device work the phase queued rather than only its launches.
  - ``trace(log_dir)``: ``torch.profiler`` over a scope, CPU and CUDA
    activity, written as a Chrome trace into log_dir (the JAX profiler's
    trace there).
  - ``annotate(name)``: a labelled range in those traces
    (``record_function``), and an NVTX range when CUDA is initialised.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_TIMINGS: dict = defaultdict(list)


def timings() -> dict:
    """All collected {scope: [seconds, ...]} so far."""
    return dict(_TIMINGS)


def reset_timings():
    _TIMINGS.clear()


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str):
    """Wall-clock scope with the device synchronized at both ends."""
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _TIMINGS[name].append(time.perf_counter() - t0)


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


@contextlib.contextmanager
def annotate(name: str):
    """Label a region in traces: ``torch.profiler.record_function``, plus
    an NVTX range when CUDA is initialised."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
