"""Prep kernel (kernel ``prep``): the fused engine's variance gate, stage 0
and OpenCV walk in one pass over the canvas → (inv_nf, alive).

Counterpart of the head of ``cascadeclassifier_tpu/detect/engine.py::
FusedEngine`` (its prep: ``dense_variance_gate``, the dense stage-0 pass
and ``parity_visited``; XLA, not Pallas), for every upright cascade kind
(stump Haar, Haar node trees, LBP, which has no gate) with f32 or
(``exact``) f64 stage sums, on the plain stack or the shelf-packed plan.
A CUDA tensor runs ``csrc/prep.cu``; a CPU tensor, or ``impl="ref"``, runs
the plain twin (``prep_ref``), which is the torch composition of
``detect/dense.py``.

The walk's inputs per plan are one byte a window, the code plane
(``walk_code``): ``ON_GRID`` where the OpenCV x-walk may visit the window
(``dense.static_visit_grid``), ``RESET`` at the columns that restart the
walk (on a shelf-packed plan, the gaps between levels that share a band
row).
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect.dense import (
    dense_variance_gate,
    parity_visited,
    stage_pass,
    static_visit_grid,
)
from cascadeclassifier_tpu_torch.detect.front import ptr

ON_GRID, RESET = 1, 2  # csrc/prep.cu: kOnGrid, kReset


def walk_code(plan) -> np.ndarray:
    """(out_h, out_w) uint8 code plane of a plan: ON_GRID on the visit grid,
    RESET on a shelf-packed plan's band rows off the grid (on ystep-2 rows
    the odd columns are off the grid by design and must not restart the
    walk)."""
    grid = static_visit_grid(plan)
    code = grid.astype(np.uint8) * ON_GRID
    if plan.packed:
        band = ~plan.row_is_plane[: plan.out_h, None]
        code |= (band & ~grid).astype(np.uint8) * RESET
    return code


def walk_inputs(code):
    """The code plane → (grid, its inclusive int32 ordinal, resets), the
    inputs of ``dense.parity_visited``."""
    grid = (code & ON_GRID) != 0
    ordinal = torch.cumsum(grid.to(torch.int32), dim=1, dtype=torch.int32)
    return grid, ordinal, (code & RESET) != 0


def prep_ref(sum2d, sq2d, code, cascade, exact=False):
    """Plain twin: the gate, stage 0 and the walk as dense torch ops."""
    grid, ordinal, reset = walk_inputs(code)
    out_h, out_w = code.shape
    st0 = cascade.stages[0]
    if cascade.is_lbp:
        passed0 = stage_pass(sum2d, st0, out_h, out_w, None, exact=exact, lbp=True)
        return None, grid & passed0 & parity_visited(~passed0, grid, ordinal, reset)
    gate, inv_nf = dense_variance_gate(sum2d, sq2d, cascade.win_w, cascade.win_h, out_h, out_w)
    passed0 = stage_pass(sum2d, st0, out_h, out_w, inv_nf, exact=exact)
    visited = parity_visited(gate & ~passed0, grid, ordinal, reset)
    return inv_nf, gate & grid & passed0 & visited


def prep(sum2d, sq2d, code, cascade, impl: str = "auto", exact: bool = False):
    """sum2d, sq2d (canvas_h, canvas_w) int32 integral canvases; code
    (out_h, out_w) uint8 (``walk_code``) with out_h = canvas_h − win_h and
    out_w = canvas_w − win_w → (inv_nf (out_h, out_w) f32, or None for
    LBP; alive (out_h, out_w) bool = gate ∧ grid ∧ stage 0 passed ∧
    visited), with f32 or (exact) f64 stage sums."""
    if cascade.has_tilted:
        raise ValueError("prep takes upright cascades; tilted ones go to detect/stage.py")
    if _build.use_ref(sum2d, impl):
        return prep_ref(sum2d, sq2d, code, cascade, exact)
    dev = sum2d.device
    _build.require(sum2d, torch.int32, 2, "sum2d", dev)
    _build.require(sq2d, torch.int32, 2, "sq2d", dev)
    _build.require(code, torch.uint8, 2, "code", dev)
    out_h, out_w = code.shape
    if (
        sq2d.shape != sum2d.shape
        or sum2d.shape[0] != out_h + cascade.win_h
        or sum2d.shape[1] != out_w + cascade.win_w
    ):
        raise ValueError("prep: canvas / code shapes disagree")
    tab = cascade.device_table(dev)
    inv_nf = None if cascade.is_lbp else torch.empty((out_h, out_w), dtype=torch.float32,
                                                     device=dev)
    alive = torch.empty((out_h, out_w), dtype=torch.bool, device=dev)
    rc = _build.lib().cct_prep(
        sum2d.data_ptr(), None if cascade.is_lbp else sq2d.data_ptr(), sum2d.shape[1],
        code.data_ptr(), ptr(inv_nf), alive.data_ptr(), out_h, out_w, cascade.win_h,
        cascade.win_w, tab["kind"], int(exact), tab["records"].data_ptr(), tab["pitch"],
        ptr(tab["tree_root"]), ptr(tab["leaves"]), tab["stage_start"].data_ptr(),
        tab["stage_thr"].data_ptr(), _build.stream_of(sum2d),
    )
    _build.check(rc, "cct_prep")
    _build.LAUNCHES["prep"] += 1
    return inv_nf, alive
