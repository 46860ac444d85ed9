"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
its 700 W limit) and the roofline arithmetic the metrics share.

A kernel's least time is the larger of its operations over the rate
and its bytes over the memory bandwidth; its roofline share is that
least time over the device time it took. Operations and bytes are
what the work needs, counted from the inputs (each input byte read
once, each output byte written once), whatever implements it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12  # FP64 outside the tensor cores


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / F64_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_pct(ops: float, nbytes: float, device_s: float) -> float | None:
    """100 · least time / device time; None without device time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) / device_s


def mfu_pct(ops: float, wall_s: float) -> float | None:
    """100 · operations / (wall seconds · the FP64 rate)."""
    if not wall_s or wall_s <= 0 or ops <= 0:
        return None
    return 100.0 * ops / (wall_s * F64_OPS_PER_S)


# --- detection: operations and bytes of a cascade over pyramid levels ---

RESIZE_OPS_PER_PIXEL = 8  # two passes of 2 multiplies and an add; round, shift
INTEGRAL_OPS_PER_PIXEL = 5  # the square, and a row and a column add for each integral
GATE_OPS_PER_WINDOW = 14  # 8 corner adds, the variance's 3, sqrt, divide, compare


def stump_ops(n_rects: int) -> int:
    """A stump of k rects: 3 corner adds and a weight multiply-add a rect
    (6k), the norm multiply, the compare and the leaf add (3)."""
    return 6 * n_rects + 3


def stage_ops(cascade) -> list:
    """Operations one window's evaluation of each stage needs."""
    nr = (cascade.weights != 0).sum(1)
    return [int(sum(stump_ops(int(nr[f])) for f in s.feature)) for s in cascade.stages]


def walk_ops(cascade, counts, first: int = 0, last: int | None = None) -> int:
    """Operations of the stages first … last−1 over the windows that
    evaluated them (``reference/detect.py::Counts``)."""
    ops = stage_ops(cascade)
    last = len(ops) if last is None else last
    return int(sum(int(counts.stage_windows[i]) * ops[i] for i in range(first, last)))


def frame_ops(cascade, counts) -> int:
    """Every operation the frames need: resize and integrals of every
    level pixel, the gate of every grid window, the stage walk."""
    pixels = sum(h * w for h, w, _ in counts.levels)
    windows = sum(n for _, _, n in counts.levels)
    return (pixels * (RESIZE_OPS_PER_PIXEL + INTEGRAL_OPS_PER_PIXEL)
            + windows * GATE_OPS_PER_WINDOW + walk_ops(cascade, counts))
