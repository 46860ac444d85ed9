"""Phase timers for the trainer.

Counterpart of ``cascadeclassifier_tpu/utils/profiling.py::timed`` and
``timings``: ``timed(name)`` appends a scope's seconds to a global
registry. When a CUDA device is initialised, the scope synchronizes it
at its start and end, so a phase time (``fill_negatives``,
``mine_values``, ``train_stage``, …) holds the device work the phase
queued rather than only its launches.
"""

from __future__ import annotations

import contextlib
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
