"""Multi-scale pyramid plan: static canvas geometry (numpy only).

A copy of ``cascadeclassifier_tpu.detect.pyramid.build_plan`` without the
per-row resize gather tables (the port resizes each level with its own
axis tables, ``detector.resize_tables``). Every pyramid level sits in an
(h_s+1) x (w_s+1) block of one (canvas_h, canvas_w) canvas whose first
row and first column are zero, so one integral image with the uniform
row stride canvas_w serves every level. Two layouts:

  - the plain vertical stack (``pack_band=False``): each level takes a
    full-width row block at column 0;
  - shelf packing (``pack_band=True``): ystep-2 levels keep the vertical
    stack, ystep-1 levels go first-fit onto shared row shelves side by
    side; the canvas shrinks ~30 % at 1080p. A level's window grid and
    level map are then 2-D (``grid2d``, ``lvl2d``), since one canvas row
    holds several levels.

Scale enumeration, ystep and grid geometry replicate OpenCV 4.x:
  - factor = 1, sf, sf², …; a level is kept while cvRound(win·factor)
    fits the image and [min,max]ObjectSize
  - scaled size = (cvRound(W/sc), cvRound(H/sc))
  - ystep = 1 if sc ≥ 2 else 2
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def _cv_round(v):
    return int(np.rint(np.float64(v)))


@dataclasses.dataclass
class PyramidPlan:
    img_w: int
    img_h: int
    win_w: int
    win_h: int
    scales: np.ndarray  # (S,) float32 factors
    scaled_w: np.ndarray  # (S,) int32
    scaled_h: np.ndarray
    ystep: np.ndarray  # (S,) int32
    box_w: np.ndarray  # (S,) cvRound(win_w*factor)
    box_h: np.ndarray
    block_top: np.ndarray  # (S,) canvas row of each level's zero row
    canvas_w: int
    canvas_h: int
    # dense-grid row descriptors (canvas rows; length canvas_h)
    row_is_grid: np.ndarray  # (canvas_h,) bool — window grid rows
    row_step2: np.ndarray  # (canvas_h,) bool — level has ystep == 2
    row_maxc: np.ndarray  # (canvas_h,) int32 — last valid window column
    row_scale: np.ndarray  # (canvas_h,) int32 — level id of the row (-1 pad)
    is_top: np.ndarray  # (canvas_h,) bool — zero rows of the stacked levels
    # shelf-packed layout (pack_band=True); block_left is zero and
    # stack_top equals block_top for the plain stack
    packed: bool = False
    block_left: np.ndarray | None = None  # (S,) canvas col of the zero col
    stack_top: np.ndarray | None = None  # (S,) row in the plain stack
    stack_h: int = 0  # rows of the plain stack (= canvas_h unpacked)
    lvl2d: np.ndarray | None = None  # (canvas_h, canvas_w) int16 level map
    row_is_plane: np.ndarray | None = None  # (canvas_h,) bool ystep-2 rows
    grid2d: np.ndarray | None = None  # (out_h, out_w) bool anchor grid

    @property
    def out_h(self):
        return self.canvas_h - self.win_h

    @property
    def out_w(self):
        return self.canvas_w - self.win_w


def opencv_scales(
    img_w, img_h, win_w, win_h, scale_factor, min_size=None, max_size=None
):
    """Replicates the scale enumeration of detectMultiScale."""
    min_w, min_h = min_size if min_size else (0, 0)
    max_w, max_h = max_size if (max_size and max_size[0] > 0) else (img_w, img_h)
    scales = []
    factor = 1.0
    while True:
        bw, bh = _cv_round(win_w * factor), _cv_round(win_h * factor)
        if bw > max_w or bh > max_h or bw > img_w or bh > img_h:
            break
        if not (bw < min_w or bh < min_h):
            scales.append(np.float32(factor))
        factor *= scale_factor
    return scales


@functools.lru_cache(maxsize=16)
def build_plan(
    img_w: int,
    img_h: int,
    win_w: int,
    win_h: int,
    scale_factor: float = 1.1,
    min_size: tuple | None = None,
    max_size: tuple | None = None,
    pack_band: bool = False,
) -> PyramidPlan:
    scales = opencv_scales(
        img_w, img_h, win_w, win_h, scale_factor, min_size, max_size
    )
    if not scales:
        raise ValueError("image smaller than detection window")
    S = len(scales)
    scaled_w = np.empty(S, np.int32)
    scaled_h = np.empty(S, np.int32)
    ystep = np.empty(S, np.int32)
    box_w = np.empty(S, np.int32)
    box_h = np.empty(S, np.int32)
    for i, sc in enumerate(scales):
        scaled_w[i] = _cv_round(img_w / sc)
        scaled_h[i] = _cv_round(img_h / sc)
        ystep[i] = 1 if sc >= 2 else 2
        # output boxes use FLOAT32 multiplies (the invoker's winSize =
        # cvRound(origWin·scalingFactor) with float scalingFactor)
        box_w[i] = _cv_round(np.float32(win_w) * sc)
        box_h[i] = _cv_round(np.float32(win_h) * sc)

    canvas_w = int(scaled_w.max()) + 1
    block_rows = scaled_h + 1
    # even block_top for ystep-2 levels, as in the JAX package, so both
    # packages share one canvas geometry
    stack_top = np.zeros(S, np.int32)
    block_top = np.zeros(S, np.int32)
    block_left = np.zeros(S, np.int32)
    top = 0
    for s in range(S):
        if ystep[s] == 2 and (top & 1):
            top += 1
        stack_top[s] = top
        top += int(block_rows[s])
    stack_h = top

    if not pack_band:
        block_top[:] = stack_top
        canvas_h = stack_h
    else:
        # ystep-2 levels keep the vertical stack; ystep-1 levels go
        # first-fit onto shelves at even columns. Levels arrive in
        # descending size, so any level fits the height of an earlier
        # shelf and only the width is checked. Window reads never leave
        # a level's block, so blocks abut with no guard.
        top = 0
        shelves = []  # [y0, x cursor]
        for s in range(S):
            hb, wb = int(block_rows[s]), int(scaled_w[s]) + 1
            if ystep[s] == 2:
                if top & 1:
                    top += 1
                block_top[s] = top
                top += hb
                continue
            for sh in shelves:
                x0 = -(-sh[1] // 2) * 2
                if x0 + wb <= canvas_w:
                    block_top[s], block_left[s] = sh[0], x0
                    sh[1] = x0 + wb
                    break
            else:
                y0 = -(-top // 2) * 2
                block_top[s], block_left[s] = y0, 0
                shelves.append([y0, wb])
                top = y0 + hb
        canvas_h = top
    # zero rows of the stacked levels; shelf-packed band levels share
    # their rows and are left out, as in the JAX package
    is_top = np.zeros(canvas_h, bool)
    is_top[block_top[ystep == 2] if pack_band else block_top] = True

    row_is_grid = np.zeros(canvas_h, bool)
    row_step2 = np.zeros(canvas_h, bool)
    row_maxc = np.full(canvas_h, -1, np.int32)
    row_scale = np.full(canvas_h, -1, np.int32)
    # OpenCV 4.x splits the y range into nstripes = cvCeil(szw0.width/32.)
    # stripes of stripeSize = max(ceil((prH/ystep)/nstripes), 1)*ystep and
    # iterates y < min(nstripes*stripeSize, prH): with ystep 2 and odd prH
    # the last grid row is visited iff nstripes does not divide prH//ystep
    nstripes = int(np.ceil((int(scaled_w[0]) + 1 - win_w) / 32.0))
    lvl2d = row_is_plane = grid2d = None
    if pack_band:
        lvl2d = np.full((canvas_h, canvas_w), -1, np.int16)
        row_is_plane = np.zeros(canvas_h, bool)
        grid2d = np.zeros((max(canvas_h - win_h, 0), max(canvas_w - win_w, 0)), bool)
    for s in range(S):
        t, h_s, w_s = int(block_top[s]), int(scaled_h[s]), int(scaled_w[s])
        le = int(block_left[s])
        step = int(ystep[s])
        if w_s < win_w or h_s < win_h:
            continue
        pr_h = h_s + 1 - win_h
        stripe = max(-(-(pr_h // step) // max(nstripes, 1)), 1) * step
        y_bound = min(max(nstripes, 1) * stripe, pr_h)
        ys = np.arange(0, y_bound, step)
        row_is_grid[t + ys] = True
        if pack_band:
            lvl2d[t : t + h_s + 1, le : le + w_s + 1] = s
            if step == 2:
                row_is_plane[t : t + h_s + 1] = True
            grid2d[np.ix_(t + ys, le + np.arange(0, w_s - win_w + 1, step))] = True
            if step == 1:
                # shared shelf rows: the per-row descriptors cannot hold
                # side-by-side levels; grid2d and lvl2d do
                continue
        row_step2[t : t + h_s + 1] = step == 2
        row_maxc[t : t + h_s + 1] = w_s - win_w
        row_scale[t : t + h_s + 1] = s

    return PyramidPlan(
        img_w=img_w,
        img_h=img_h,
        win_w=win_w,
        win_h=win_h,
        scales=np.array(scales, np.float32),
        scaled_w=scaled_w,
        scaled_h=scaled_h,
        ystep=ystep,
        box_w=box_w,
        box_h=box_h,
        block_top=block_top,
        canvas_w=canvas_w,
        canvas_h=canvas_h,
        row_is_grid=row_is_grid,
        row_step2=row_step2,
        row_maxc=row_maxc,
        row_scale=row_scale,
        is_top=is_top,
        packed=pack_band,
        block_left=block_left,
        stack_top=stack_top,
        stack_h=stack_h,
        lvl2d=lvl2d,
        row_is_plane=row_is_plane,
        grid2d=grid2d,
    )
