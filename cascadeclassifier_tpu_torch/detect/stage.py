"""Stage kernel (kernel ``stage``): stump-Haar stages [s0, s1), upright
and tilted, at every alive canvas window, with stage 0's pass mask.

Counterpart of ``cascadeclassifier_tpu/detect/pallas_stage.py::
make_pallas_chunk_fn`` (``collect_passed0=True``, ``use_tilted`` as the
cascade needs). A CUDA tensor runs ``csrc/stage.cu``; a CPU tensor, or
``impl="ref"``, runs the plain twin (``stage_ref``).
"""

from __future__ import annotations

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect import records
from cascadeclassifier_tpu_torch.detect.dense import stage_pass, window_stage_pass


def stage_ref(sum2d, tilt2d, inv_nf, alive, cascade, s0, s1):
    """Plain twin: stage 0 densely at every window when the chunk starts
    there (its pass mask is an output), then each later stage at the
    windows still alive, gathered (the kernel's per-window early exit)."""
    out_h, out_w = alive.shape
    passed0 = torch.zeros_like(alive)
    if s0 == 0 < s1:
        passed0 = stage_pass(sum2d, cascade.stages[0], out_h, out_w, inv_nf, tilt2d)
        alive = alive & passed0
        s0 = 1
    idx = torch.nonzero(alive.reshape(-1)).squeeze(1)
    for si in range(s0, s1):
        if idx.numel() == 0:
            break
        passed = window_stage_pass(sum2d, tilt2d, cascade.stages[si], idx, out_w,
                                   inv_nf.reshape(-1)[idx])
        idx = idx[passed]
    out = torch.zeros(out_h * out_w, dtype=torch.bool, device=alive.device)
    out[idx] = True
    return out.reshape(out_h, out_w), passed0


def stage(sum2d, tilt2d, inv_nf, alive, cascade, s0: int, s1: int, impl: str = "auto"):
    """sum2d, tilt2d (canvas_h, canvas_w) int32 integral and tilted
    canvases (tilt2d may be sum2d when no tree is tilted); inv_nf (out_h,
    out_w) f32; alive (out_h, out_w) bool with out_h = canvas_h − win_h
    and out_w = canvas_w − win_w → (alive ∧ stages [s0, s1) passed,
    passed0), both bool; passed0 is stage 0's pass mask at every window
    when s0 == 0 < s1, all False otherwise."""
    if not 0 <= s0 <= s1 <= len(cascade.stages):
        raise ValueError(f"stage range [{s0}, {s1}) out of bounds")
    if _build.use_ref(sum2d, impl):
        return stage_ref(sum2d, tilt2d, inv_nf, alive, cascade, s0, s1)
    dev = sum2d.device
    _build.require(sum2d, torch.int32, 2, "sum2d", dev)
    _build.require(tilt2d, torch.int32, 2, "tilt2d", dev)
    _build.require(inv_nf, torch.float32, 2, "inv_nf", dev)
    _build.require(alive, torch.bool, 2, "alive", dev)
    out_h, out_w = alive.shape
    if (
        tuple(inv_nf.shape) != (out_h, out_w)
        or tilt2d.shape != sum2d.shape
        or sum2d.shape[0] != out_h + cascade.win_h
        or sum2d.shape[1] != out_w + cascade.win_w
    ):
        raise ValueError("stage: canvas / mask / inv_nf shapes disagree")
    tab = cascade.device_table(dev)
    out = torch.empty_like(alive)
    passed0 = torch.empty_like(alive)
    code = _build.lib().cct_stage(
        sum2d.data_ptr(), tilt2d.data_ptr(), int(tab["has_tilted"]), sum2d.shape[1],
        inv_nf.data_ptr(), alive.data_ptr(), out.data_ptr(), passed0.data_ptr(), out_h,
        out_w, cascade.win_h, cascade.win_w, tab["records"].data_ptr(), tab["pitch"],
        records.TILE_H,
        tab["stage_start"].data_ptr(), tab["stage_thr"].data_ptr(), s0, s1,
        _build.stream_of(sum2d),
    )
    _build.check(code, "cct_stage")
    _build.LAUNCHES["stage"] += 1
    return out, passed0
