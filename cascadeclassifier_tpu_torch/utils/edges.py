"""Edge cases of the tiled front, packed front and stage kernels, of the
tilted kernel and of the integral kernel against their twins.

Front and stage: small one-block canvases whose window grid is one less
than, equal to and one more than two tiles each way; masks that leave
every tile dead, every window alive, one window alive in the last row and
column, and a checkerboard. The packed front takes the same and a grid
one column wider than a listed block, each with six block lists
(``block_lists``). The pixels are a synthetic frame (``utils/synth.py``,
integer-only numpy, seeded by the frame number), taken through the
port's own integral, tilted integral and variance gate on the given
device. The tilted kernel takes random canvases with runs of rows around
its chunks and widths around its strips (``tilted_edge_cases``). The
integral kernel takes random canvases of heights around its bands and
widths around a warp and its passes, as uint8 and as int32 with values up
to 2^20, so that both sums wrap (``integral_edge_cases``).
``chip_smoke.py`` and the card's tests run the same cases.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import (
    APPLY_COLS,
    APPLY_THREADS,
    BAND_ROWS,
    integral,
)
from cascadeclassifier_tpu_torch.detect.packed_front import (
    BLK_W,
    block_grid,
    live_block_list,
    packed_front,
)
from cascadeclassifier_tpu_torch.detect.records import TILE_H, TILE_W
from cascadeclassifier_tpu_torch.detect.stage import stage
from cascadeclassifier_tpu_torch.detect.tilted import CHUNK_ROWS, STRIP_COLS, tilted
from cascadeclassifier_tpu_torch.utils.synth import synth_frame

SHAPES = tuple((2 * TILE_H + d, 2 * TILE_W + d) for d in (-1, 0, 1))
FRONT_RANGES = ((1, 8), (3, 5), (4, 4))
STAGE_RANGES = ((0, 30), (0, 1), (1, 30), (5, 9))
# the last grid crosses a listed block's right edge by one column
PACKED_SHAPES = SHAPES + ((2 * TILE_H + 1, BLK_W + 1),)
PACKED_RANGES = ((1, 8), (4, 4))
# Runs of canvas rows, each but the first led by its top. Computed rows: 3
# (row 0 is no top), 0 (a top alone), 1, 2, one short of a chunk, a chunk,
# one past it, two chunks and two rows, and 0 (a top in the last row).
TILTED_RUNS = (3, 1, 2, 3, CHUNK_ROWS, CHUNK_ROWS + 1, CHUNK_ROWS + 2, 2 * CHUNK_ROWS + 3, 1)
TILTED_WIDTHS = (1, 37, STRIP_COLS - 1, STRIP_COLS, STRIP_COLS + 1, 2 * STRIP_COLS - 1,
                 2 * STRIP_COLS + 1)
TILTED_PADS = (0, 3, 2 * CHUNK_ROWS + 4, 500)  # the third: the tallest run's rows + 1, exact
# one band, one row short of, at and one past a band, and three bands and a
# part; one column, one short of, at and past a warp, the 1080p and 4K
# canvas widths, and at and past one pass of the apply kernel
INTEGRAL_HEIGHTS = (1, BAND_ROWS - 1, BAND_ROWS, BAND_ROWS + 1, 3 * BAND_ROWS + 5)
INTEGRAL_WIDTHS = (1, 31, 32, 33, 1921, 3841, APPLY_THREADS * APPLY_COLS,
                   APPLY_THREADS * APPLY_COLS + 1)


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


def block_lists(alive) -> dict:
    """name → (blk, nblk) for a mask: the live blocks as the engine lists
    them; every block; every block with nblk one short; nblk 0; entries
    outside the block grid ahead of every block; every block in reverse
    order."""
    dev = alive.device
    every, _ = live_block_list(torch.ones_like(alive))
    nb = every.shape[0]
    nbr, nbc = block_grid(*alive.shape)
    stray = torch.tensor([[nbr, 0], [0, nbc], [-1, 0], [0, -1]], dtype=torch.int32, device=dev)

    def count(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    return {
        "live blocks": live_block_list(alive),
        "every block": (every, count(nb)),
        "cut short": (every, count(nb - 1)),
        "nblk 0": (every, count(0)),
        "stray entries": (torch.cat([stray, every]), count(nb + len(stray))),
        "reverse order": (every.flip(0).contiguous(), count(nb)),
    }


def packed_edge_mismatches(cascade, device):
    """packed_front over every shape x mask x block list x stage range
    against its twin, and against ``front`` where every block is listed
    → (cases run, survivors summed, descriptions of the cases that
    differ)."""
    n, survivors, bad = 0, 0, []
    for k, (out_h, out_w) in enumerate(PACKED_SHAPES):
        sum2d, _, inv_nf = edge_inputs(k, out_h, out_w, cascade, device, False)
        for name, alive in edge_masks(out_h, out_w, device).items():
            for lname, (blk, nblk) in block_lists(alive).items():
                for s0, s1 in PACKED_RANGES:
                    args = (sum2d, inv_nf, alive, blk, nblk, cascade, s0, s1)
                    got = packed_front(*args)
                    same = torch.equal(got, packed_front(*args, impl="ref"))
                    if lname in ("every block", "reverse order", "stray entries"):
                        same = same and torch.equal(
                            got, front(sum2d, inv_nf, alive, cascade, s0, s1))
                    n += 1
                    survivors += int(got.sum())
                    if not same:
                        bad.append(f"{out_h}x{out_w} windows, {name}, {lname}, "
                                   f"stages [{s0}, {s1})")
    return n, survivors, bad


def tilted_edge_cases():
    """(px (rows, w) int32 numpy, is_top, pad) per width and pad. The
    pixels are random everywhere, block tops and column 0 included: the
    kernel and the twin both skip those cells."""
    is_top = np.zeros(sum(TILTED_RUNS), bool)
    is_top[np.cumsum(TILTED_RUNS)[:-1]] = True
    for i, w in enumerate(TILTED_WIDTHS):
        px = np.random.default_rng(100 + i).integers(0, 256, (len(is_top), w)).astype(np.int32)
        for pad in TILTED_PADS:
            yield px, is_top, pad


def tilted_edge_mismatches(device):
    """tilted over tilted_edge_cases() against its twin → (cases run,
    descriptions of the cases that differ)."""
    n, bad = 0, []
    for px, is_top, pad in tilted_edge_cases():
        pxd = torch.from_numpy(px).to(device)
        n += 1
        if not torch.equal(tilted(pxd, is_top, pad), tilted(pxd, is_top, pad, impl="ref")):
            bad.append(f"{px.shape[1]} columns, pad {pad}")
    return n, bad


def integral_edge_cases():
    """px (h, w) numpy per height x width x type: uint8 over [0, 256),
    then int32 over [0, 2^20)."""
    for i, (h, w) in enumerate(itertools.product(INTEGRAL_HEIGHTS, INTEGRAL_WIDTHS)):
        rng = np.random.default_rng(200 + i)
        yield rng.integers(0, 256, (h, w)).astype(np.uint8)
        yield rng.integers(0, 1 << 20, (h, w)).astype(np.int32)


def integral_edge_mismatches(device):
    """integral over integral_edge_cases() against its twin → (cases run,
    descriptions of the cases that differ)."""
    n, bad = 0, []
    for px in integral_edge_cases():
        pxd = torch.from_numpy(px).to(device)
        got, want = integral(pxd), integral(pxd, impl="ref")
        n += 1
        if not all(torch.equal(g, r) for g, r in zip(got, want)):
            bad.append(f"{px.shape[0]}x{px.shape[1]} {px.dtype}")
    return n, bad
