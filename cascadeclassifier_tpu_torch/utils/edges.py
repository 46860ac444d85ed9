"""Edge cases of the tiled front and stage kernels against their twins.

Small one-block canvases whose window grid is one less than, equal to
and one more than two tiles each way; masks that leave every tile dead,
every window alive, one window alive in the last row and column, and a
checkerboard. ``chip_smoke.py`` and the card's tests run the same cases.
The pixels are a synthetic frame (``utils/synth.py``, integer-only
numpy, seeded by the frame number), taken through the port's own
integral, tilted integral and variance gate on the given device.
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import integral
from cascadeclassifier_tpu_torch.detect.records import TILE_H, TILE_W
from cascadeclassifier_tpu_torch.detect.stage import stage
from cascadeclassifier_tpu_torch.detect.tilted import tilted
from cascadeclassifier_tpu_torch.utils.synth import synth_frame

SHAPES = tuple((2 * TILE_H + d, 2 * TILE_W + d) for d in (-1, 0, 1))
FRONT_RANGES = ((1, 8), (3, 5), (4, 4))
STAGE_RANGES = ((0, 30), (0, 1), (1, 30), (5, 9))


def edge_masks(out_h: int, out_w: int, device) -> dict:
    """name → (out_h, out_w) bool alive mask."""
    last = torch.zeros((out_h, out_w), dtype=torch.bool, device=device)
    last[-1, -1] = True
    rows = torch.arange(out_h, device=device)[:, None]
    cols = torch.arange(out_w, device=device)[None, :]
    return {
        "all dead": torch.zeros_like(last),
        "all alive": torch.ones_like(last),
        "last window": last,
        "checkerboard": ((rows + cols) & 1) == 0,
    }


def edge_inputs(k: int, out_h: int, out_w: int, cascade, device, with_tilted: bool):
    """Frame k as one pyramid block of out_h x out_w windows → (sum2d,
    tilt2d, inv_nf); tilt2d is sum2d unless with_tilted."""
    canvas_h, canvas_w = out_h + cascade.win_h, out_w + cascade.win_w
    px = np.zeros((canvas_h, canvas_w), np.int32)
    px[1:, 1:] = synth_frame(k, canvas_h - 1, canvas_w - 1)
    px = torch.from_numpy(px).to(device)
    sum2d, sq2d = integral(px)
    tilt2d = sum2d
    if with_tilted:
        is_top = np.zeros(canvas_h, bool)
        is_top[0] = True
        tilt2d = tilted(px, is_top, canvas_h + 1)
    _, inv_nf = dense_variance_gate(sum2d, sq2d, cascade.win_w, cascade.win_h, out_h, out_w)
    return sum2d, tilt2d, inv_nf


def edge_mismatches(cascade, ranges, device, use_stage: bool):
    """Runs every shape x mask x stage range through the kernel (on a
    CUDA device) and through its twin → (cases run, survivors summed
    over the cases, descriptions of the cases that differ). use_stage:
    the stage kernel (alive and passed0), with the tilted canvas when the
    cascade has tilted trees and sum2d in its place otherwise; else the
    front kernel."""
    n, survivors, bad = 0, 0, []
    for k, (out_h, out_w) in enumerate(SHAPES):
        sum2d, tilt2d, inv_nf = edge_inputs(k, out_h, out_w, cascade, device,
                                            use_stage and cascade.has_tilted)
        for name, alive in edge_masks(out_h, out_w, device).items():
            for s0, s1 in ranges:
                if use_stage:
                    got = stage(sum2d, tilt2d, inv_nf, alive, cascade, s0, s1)
                    want = stage(sum2d, tilt2d, inv_nf, alive, cascade, s0, s1, impl="ref")
                else:
                    got = (front(sum2d, inv_nf, alive, cascade, s0, s1),)
                    want = (front(sum2d, inv_nf, alive, cascade, s0, s1, impl="ref"),)
                n += 1
                survivors += int(got[0].sum())
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    bad.append(f"{out_h}x{out_w} windows, {name}, stages [{s0}, {s1})")
    return n, survivors, bad
