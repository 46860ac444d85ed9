"""Cascade front (kernel 2): stages [s0, s1) at every alive canvas window.

Counterpart of ``cascadeclassifier_tpu/detect/pallas_front.py::
make_static_front_fn`` (ystep-1 band) and ``make_plane_front_fn`` (ystep-2
anchors): one kernel, ``csrc/front.cu``, serves both on the canvas-layout
mask, for every upright cascade kind (stump Haar, Haar node trees, LBP;
``PackedCascade.kind``) with f32 or (``exact``) f64 stage sums, which
the JAX package's fused engine runs in XLA. A CUDA tensor runs the
kernel; a CPU tensor, or ``impl="ref"``, runs the plain twin
(``dense.stage_pass`` per stage).
"""

from __future__ import annotations

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect.dense import stage_pass


def front_ref(sum2d, inv_nf, alive, cascade, s0, s1, exact=False):
    """Plain twin: alive ∧ every stage in [s0, s1) passed, densely."""
    out_h, out_w = alive.shape
    for si in range(s0, s1):
        alive = alive & stage_pass(sum2d, cascade.stages[si], out_h, out_w, inv_nf,
                                   exact=exact, lbp=cascade.is_lbp)
    return alive


def check_stages(cascade, s0: int, s1: int):
    """The front takes an upright cascade and a stage range inside it."""
    if not 0 <= s0 <= s1 <= len(cascade.stages):
        raise ValueError(f"stage range [{s0}, {s1}) out of bounds")
    if cascade.has_tilted:
        raise ValueError("front takes upright cascades; tilted ones go to detect/stage.py")


def check_inputs(sum2d, inv_nf, alive, cascade):
    """Device, dtype, rank, contiguity and shapes of a front kernel's
    canvas, inv_nf (None for LBP, which reads none) and mask."""
    dev = sum2d.device
    _build.require(sum2d, torch.int32, 2, "sum2d", dev)
    _build.require(alive, torch.bool, 2, "alive", dev)
    out_h, out_w = alive.shape
    if inv_nf is None:
        if not cascade.is_lbp:
            raise ValueError("a Haar cascade needs inv_nf")
    else:
        _build.require(inv_nf, torch.float32, 2, "inv_nf", dev)
    if (
        (inv_nf is not None and tuple(inv_nf.shape) != (out_h, out_w))
        or sum2d.shape[0] != out_h + cascade.win_h
        or sum2d.shape[1] != out_w + cascade.win_w
    ):
        raise ValueError("front: canvas / mask / inv_nf shapes disagree")


def ptr(t):
    """A tensor's device address, or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def front(sum2d, inv_nf, alive, cascade, s0: int, s1: int, impl: str = "auto",
          exact: bool = False):
    """sum2d (canvas_h, canvas_w) int32 integral canvas; inv_nf (out_h,
    out_w) f32 (None for LBP); alive (out_h, out_w) bool with out_h =
    canvas_h − win_h and out_w = canvas_w − win_w → alive ∧ stages [s0, s1)
    passed (bool), with f32 or (exact) f64 stage sums."""
    check_stages(cascade, s0, s1)
    if _build.use_ref(sum2d, impl):
        return front_ref(sum2d, inv_nf, alive, cascade, s0, s1, exact)
    check_inputs(sum2d, inv_nf, alive, cascade)
    dev = sum2d.device
    out_h, out_w = alive.shape
    tab = cascade.device_table(dev)
    out = torch.empty_like(alive)
    code = _build.lib().cct_front(
        sum2d.data_ptr(), sum2d.shape[1], ptr(inv_nf),
        alive.data_ptr(), out.data_ptr(), out_h, out_w, cascade.win_h, cascade.win_w,
        tab["kind"], int(exact), tab["records"].data_ptr(), tab["pitch"],
        ptr(tab["tree_root"]), ptr(tab["leaves"]), tab["stage_start"].data_ptr(),
        tab["stage_thr"].data_ptr(), s0, s1, _build.stream_of(sum2d),
    )
    _build.check(code, "cct_front")
    _build.LAUNCHES["front"] += 1
    return out
