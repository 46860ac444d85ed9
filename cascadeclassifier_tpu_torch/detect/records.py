"""Packed tree records and the window tiles of the front and stage kernels.

``csrc/front.cu`` and ``csrc/stage.cu`` give one thread block a tile of
``TILE_H`` x ``TILE_W`` canvas windows. The block copies the (TILE_H +
win_h) x (TILE_W + win_w) patch of the integral canvas that those
windows read into shared memory, rows ``tile_pitch(win_w)`` cells apart,
and for a cascade with tilted trees the same patch of the tilted canvas
right behind it. A tree's parameters reach the kernels as one 48-byte
record (``RECORD``): per weighted rect its four corners as cell offsets
from the window's own cell in that shared-memory image, the rect
weights, and the stump's threshold and leaves.

  corner[r] = (c0, c1, c2, c3) with rect sum = c0 - c1 - c2 + c3
      upright (x, y, w, h): (x, y), (x+w, y), (x, y+h), (x+w, y+h)
      tilted:               (x, y), (x-h, y+h), (x+w, y+w), (x+w-h, y+w+h),
                            each plus ``tilt_bias`` (the tilted patch's
                            offset from the integral patch)
  weight[r] = the rect's weight; the weighted rects come first, in their
      order, and the unused slots hold weight 0 and corners 0, so the
      count of weighted rects is the count of leading nonzero weights
  thr, left, right = the stump

The kernels read a record as three 16-byte words. Everything here is
numpy; ``records_stage_pass`` repeats the kernels' per-tile arithmetic on
the CPU, so that the tests can hold the encoding against
``dense.stage_pass``.
"""

from __future__ import annotations

import numpy as np

TILE_H = 16  # csrc/stage.cu: CCT_STAGE_TILE_H
TILE_W = 128  # csrc/cascade_tile.cuh: kTileW
PITCHES = (152, 200, 264)  # csrc/cascade_tile.cuh: the pitches dispatch() instantiates

RECORD = np.dtype([
    ("corner", "<u2", (3, 4)),
    ("weight", "<f4", (3,)),
    ("thr", "<f4"),
    ("left", "<f4"),
    ("right", "<f4"),
])
assert RECORD.itemsize == 48


def tile_pitch(win_w: int) -> int:
    """Cells between two rows of the shared-memory patch: the least
    compiled pitch that holds TILE_W + win_w columns."""
    for pitch in PITCHES:
        if TILE_W + win_w <= pitch:
            return pitch
    raise ValueError(f"window width {win_w} exceeds the kernels' widest tile "
                     f"({PITCHES[-1] - TILE_W})")


def tilt_bias(win_w: int, win_h: int) -> int:
    """Cell offset of the tilted patch from the integral patch."""
    return (TILE_H + win_h) * tile_pitch(win_w)


def corner_cells(x: int, y: int, w: int, h: int, tilted: bool):
    """The four (dx, dy) corners of a rect, in the order c0 - c1 - c2 + c3."""
    if tilted:
        return (x, y), (x - h, y + h), (x + w, y + w), (x + w - h, y + w + h)
    return (x, y), (x + w, y), (x, y + h), (x + w, y + h)


def tree_records(stages, win_w: int, win_h: int) -> np.ndarray:
    """Every tree of the stages, in order, as a (T,) RECORD array."""
    pitch = tile_pitch(win_w)
    bias = tilt_bias(win_w, win_h)
    if 2 * bias > 1 << 16:
        raise ValueError(f"a {win_w}x{win_h} window's tile does not fit 16-bit corner offsets")
    if any(st.ntrees == 0 for st in stages):
        raise ValueError("a stage without trees")
    rec = np.zeros(sum(st.ntrees for st in stages), RECORD)
    t = 0
    for st in stages:
        for i in range(st.ntrees):
            tilted = bool(st.tilted[i])
            slot = 0
            for r in range(3):
                if st.weights[i, r] == 0:
                    continue
                cells = corner_cells(*(int(v) for v in st.feat_rects[i, r]), tilted)
                rec["corner"][t, slot] = [dy * pitch + dx + bias * tilted for dx, dy in cells]
                rec["weight"][t, slot] = st.weights[i, r]
                slot += 1
            rec["thr"][t] = st.thr[i]
            rec["left"][t] = st.left_leaf[i]
            rec["right"][t] = st.right_leaf[i]
            t += 1
    return rec


def decode_records(rec: np.ndarray, win_w: int, win_h: int) -> dict:
    """The records back as PackedStage's arrays over all trees:
    feat_rects (T, 3, 4), weights (T, 3), tilted (T,), thr, left_leaf,
    right_leaf (T,). Unused rect slots decode to zeros."""
    pitch = tile_pitch(win_w)
    bias = tilt_bias(win_w, win_h)
    corner = rec["corner"].astype(np.int64)
    used = rec["weight"] != 0
    tilted = (used & (corner[:, :, 0] >= bias)).any(axis=1)
    corner = corner - bias * tilted[:, None, None]
    cy, cx = corner // pitch, corner % pitch
    x, y = cx[:, :, 0], cy[:, :, 0]
    # upright: c1 = (x+w, y), c2 = (x, y+h); tilted: c2 = (x+w, y+w), c1 = (x-h, y+h)
    w = np.where(tilted[:, None], cx[:, :, 2] - x, cx[:, :, 1] - x)
    h = np.where(tilted[:, None], cy[:, :, 1] - y, cy[:, :, 2] - y)
    rects = np.stack([x, y, w, h], axis=2) * used[:, :, None]
    return dict(feat_rects=rects.astype(np.int32), weights=rec["weight"].copy(),
                tilted=tilted, thr=rec["thr"].copy(), left_leaf=rec["left"].copy(),
                right_leaf=rec["right"].copy())


def tile_cover(out_h: int, out_w: int) -> list:
    """(r0, c0, rows, cols) of every tile of the kernels' grid: tile
    (by, bx) starts at window (by * TILE_H, bx * TILE_W) and the tiles at
    the right and bottom edges are cut to the windows that exist."""
    return [
        (r0, c0, min(TILE_H, out_h - r0), min(TILE_W, out_w - c0))
        for r0 in range(0, out_h, TILE_H)
        for c0 in range(0, out_w, TILE_W)
    ]


def records_stage_pass(rec, stage_thr, sum2d, tilt2d, inv_nf, win_w: int, win_h: int):
    """One stage (its trees' records, in order) at every window, tile by
    tile as the kernels do it: the patches copied into one flat image
    (zeros past the canvas), every corner read at window cell + record
    offset, sums in uint32 read as int32, f32 arithmetic in the kernels'
    order. sum2d, tilt2d (canvas_h, canvas_w) int32 numpy (tilt2d may be
    None when no tree is tilted); inv_nf (out_h, out_w) f32 → bool mask."""
    pitch = tile_pitch(win_w)
    rows = TILE_H + win_h
    out_h, out_w = inv_nf.shape
    canvases = [sum2d] if tilt2d is None else [sum2d, tilt2d]
    cell = (np.arange(TILE_H)[:, None] * pitch + np.arange(TILE_W)[None, :]).astype(np.int64)
    passed = np.zeros((out_h, out_w), bool)
    for r0, c0, th, tw in tile_cover(out_h, out_w):
        image = np.zeros((len(canvases), rows, pitch), np.uint32)
        for k, canvas in enumerate(canvases):
            patch = canvas[r0 : r0 + rows, c0 : c0 + TILE_W + win_w]
            image[k, : patch.shape[0], : patch.shape[1]] = patch.view(np.uint32)
        flat = image.reshape(-1)
        inv = np.ones((TILE_H, TILE_W), np.float32)
        inv[:th, :tw] = inv_nf[r0 : r0 + th, c0 : c0 + tw]
        ssum = np.zeros((TILE_H, TILE_W), np.float32)
        for tree in rec:
            raw = None
            for r in range(3):
                wt = tree["weight"][r]
                if wt == 0:
                    break
                c = tree["corner"][r].astype(np.int64)
                u = flat[cell + c[0]] - flat[cell + c[1]] - flat[cell + c[2]] + flat[cell + c[3]]
                term = u.view(np.int32).astype(np.float32) * wt
                raw = term if raw is None else raw + term
            if raw is None:
                raw = np.zeros((TILE_H, TILE_W), np.float32)
            val = raw * inv
            ssum = ssum + np.where(val < tree["thr"], tree["left"], tree["right"])
        passed[r0 : r0 + th, c0 : c0 + tw] = (ssum >= np.float32(stage_thr))[:th, :tw]
    return passed
