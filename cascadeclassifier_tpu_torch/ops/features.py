"""Feature catalogs and evaluators.

The Haar, LBP and HOG catalogs (numpy) are copies of
``cascadeclassifier_tpu/ops/features.py``: the port imports nothing of the
JAX package. Catalogs are generated in **exactly the enumeration order of
the reference generators** (haarfeatures.cpp:127-251,
lbpfeatures.cpp:35-45, HOGfeatures.cpp:67-106): variable indices stored in cascade XML index into
this order. ``eval_haar``, ``lbp_code_grid`` and ``eval_lbp`` are plain
PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

HAAR_BASIC, HAAR_CORE, HAAR_ALL = 0, 1, 2
_HAAR_MODE_NAMES = {"BASIC": HAAR_BASIC, "CORE": HAAR_CORE, "ALL": HAAR_ALL}


def haar_mode_id(mode) -> int:
    if isinstance(mode, str):
        return _HAAR_MODE_NAMES[mode.upper()]
    return int(mode)


def sum_offsets(x, y, w, h, stride):
    """Corner offsets of an upright rect in a flattened integral image.

    Mirrors CV_SUM_OFFSETS (traincascade_features.h:41-50):
      p0=(x,y) p1=(x+w,y) p2=(x,y+h) p3=(x+w,y+h); rectsum = S[p0]-S[p1]-S[p2]+S[p3].
    """
    p0 = x + stride * y
    p1 = x + w + stride * y
    p2 = x + stride * (y + h)
    p3 = x + w + stride * (y + h)
    return p0, p1, p2, p3


def tilted_offsets(x, y, w, h, stride):
    """Corner offsets of a 45°-tilted rect in a flattened tilted integral.

    Mirrors CV_TILTED_OFFSETS (traincascade_features.h:54-63).
    """
    p0 = x + stride * y
    p1 = x - h + stride * (y + h)
    p2 = x + w + stride * (y + w)
    p3 = x + w - h + stride * (y + w + h)
    return p0, p1, p2, p3


# --------------------------------------------------------------------------
# Haar
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HaarCatalog:
    """All Haar features for a window, in reference enumeration order.

    rects   : (F, 3, 4) int32 — (x, y, w, h); zero-size for unused slots
    weights : (F, 3) float32  — 0.0 for unused slots
    tilted  : (F,) bool
    win_w, win_h : window size the catalog was generated for
    mode    : HAAR_BASIC / HAAR_CORE / HAAR_ALL
    """

    rects: np.ndarray
    weights: np.ndarray
    tilted: np.ndarray
    win_w: int
    win_h: int
    mode: int

    def __len__(self):
        return self.rects.shape[0]

    def corner_offsets(self) -> np.ndarray:
        """(F, 3, 4) int32 flat offsets into (win_h+1)*(win_w+1) rows."""
        stride = self.win_w + 1
        x, y = self.rects[:, :, 0], self.rects[:, :, 1]
        w, h = self.rects[:, :, 2], self.rects[:, :, 3]
        up = np.stack(sum_offsets(x, y, w, h, stride), axis=-1)
        ti = np.stack(tilted_offsets(x, y, w, h, stride), axis=-1)
        out = np.where(self.tilted[:, None, None], ti, up).astype(np.int32)
        # unused slots (w==0) could produce negative offsets for tilted rects;
        # clamp to 0 — their weight is 0 so the gathered value is ignored.
        return np.clip(out, 0, None)


def haar_catalog(win_w: int, win_h: int, mode=HAAR_BASIC) -> HaarCatalog:
    """Enumerate Haar features exactly as haarfeatures.cpp:127-251.

    Loop order is x, y, dx, dy (dx/dy from 1), and for each combination the
    applicable templates are appended in the fixed order
    x2, y2, x3, y3, [x4, y4], x2_y2, [center3x3], [6 tilted kinds].
    The implementation is vectorized: each template contributes the set of
    valid (x, y, dx, dy) tuples; a lexicographic (x, y, dx, dy, template)
    sort key then reproduces the exact append order.
    """
    mode = haar_mode_id(mode)
    W, H = win_w, win_h
    x = np.arange(W, dtype=np.int64)[:, None, None, None]
    y = np.arange(H, dtype=np.int64)[None, :, None, None]
    dx = np.arange(1, W + 1, dtype=np.int64)[None, None, :, None]
    dy = np.arange(1, H + 1, dtype=np.int64)[None, None, None, :]

    # template table: (rank, condition, tilted, rect constructor)
    # each constructor returns (rects(3,4), weights(3)) as numpy expressions over
    # the selected x/y/dx/dy vectors.
    entries = []  # (key, rects(n,3,4), weights(3), tilted)

    def emit(rank, cond, tilted_flag, build):
        idx = np.nonzero(np.broadcast_to(cond, (W, H, W, H)))
        if idx[0].size == 0:
            return
        xs, ys = x.ravel()[idx[0]], y.ravel()[idx[1]]
        dxs, dys = dx.ravel()[idx[2]], dy.ravel()[idx[3]]
        rects, weights = build(xs, ys, dxs, dys)
        key = (((xs * H + ys) * W + (dxs - 1)) * H + (dys - 1)) * 32 + rank
        entries.append((key, rects, weights, tilted_flag))

    def R(*rect_weight_pairs):
        """Build (n,3,4) rects + (3,) weights from up to 3 (x,y,w,h,wt)."""

        def build(n, pairs):
            rects = np.zeros((n, 3, 4), np.int32)
            weights = np.zeros((3,), np.float32)
            for i, (rx, ry, rw, rh, wt) in enumerate(pairs):
                rects[:, i, 0] = rx
                rects[:, i, 1] = ry
                rects[:, i, 2] = rw
                rects[:, i, 3] = rh
                weights[i] = wt
            return rects, weights

        return build, rect_weight_pairs

    rank = 0

    def add(cond, tilted_flag, make_pairs):
        nonlocal rank
        r = rank
        rank += 1

        def build(xs, ys, dxs, dys):
            pairs = make_pairs(xs, ys, dxs, dys)
            n = xs.shape[0]
            rects = np.zeros((n, 3, 4), np.int32)
            weights = np.zeros((3,), np.float32)
            for i, (rx, ry, rw, rh, wt) in enumerate(pairs):
                rects[:, i, 0] = rx
                rects[:, i, 1] = ry
                rects[:, i, 2] = rw
                rects[:, i, 3] = rh
                weights[i] = wt
            return rects, weights

        emit(r, cond, tilted_flag, build)

    # haar_x2
    add(
        (x + dx * 2 <= W) & (y + dy <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs * 2, dys, -1.0),
            (xs + dxs, ys, dxs, dys, +2.0),
        ],
    )
    # haar_y2
    add(
        (x + dx <= W) & (y + dy * 2 <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs, dys * 2, -1.0),
            (xs, ys + dys, dxs, dys, +2.0),
        ],
    )
    # haar_x3
    add(
        (x + dx * 3 <= W) & (y + dy <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs * 3, dys, -1.0),
            (xs + dxs, ys, dxs, dys, +2.0),
        ],
    )
    # haar_y3
    add(
        (x + dx <= W) & (y + dy * 3 <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs, dys * 3, -1.0),
            (xs, ys + dys, dxs, dys, +2.0),
        ],
    )
    if mode != HAAR_BASIC:
        # haar_x4
        add(
            (x + dx * 4 <= W) & (y + dy <= H),
            False,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 4, dys, -1.0),
                (xs + dxs, ys, dxs * 2, dys, +2.0),
            ],
        )
        # haar_y4
        add(
            (x + dx <= W) & (y + dy * 4 <= H),
            False,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, dys * 4, -1.0),
                (xs, ys + dys, dxs, dys * 2, +2.0),
            ],
        )
    # x2_y2 (checkerboard)
    add(
        (x + dx * 2 <= W) & (y + dy * 2 <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs * 2, dys * 2, -1.0),
            (xs, ys, dxs, dys, +2.0),
            (xs + dxs, ys + dys, dxs, dys, +2.0),
        ],
    )
    if mode != HAAR_BASIC:
        # 3x3 center-surround
        add(
            (x + dx * 3 <= W) & (y + dy * 3 <= H),
            False,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 3, dys * 3, -1.0),
                (xs + dxs, ys + dys, dxs, dys, +9.0),
            ],
        )
    if mode == HAAR_ALL:
        # tilted haar_x2
        add(
            (x + 2 * dx <= W) & (y + 2 * dx + dy <= H) & (x - dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 2, dys, -1.0),
                (xs, ys, dxs, dys, +2.0),
            ],
        )
        # tilted haar_y2
        add(
            (x + dx <= W) & (y + dx + 2 * dy <= H) & (x - 2 * dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, 2 * dys, -1.0),
                (xs, ys, dxs, dys, +2.0),
            ],
        )
        # tilted haar_x3
        add(
            (x + 3 * dx <= W) & (y + 3 * dx + dy <= H) & (x - dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 3, dys, -1.0),
                (xs + dxs, ys + dxs, dxs, dys, +3.0),
            ],
        )
        # tilted haar_y3
        add(
            (x + dx <= W) & (y + dx + 3 * dy <= H) & (x - 3 * dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, 3 * dys, -1.0),
                (xs - dys, ys + dys, dxs, dys, +3.0),
            ],
        )
        # tilted haar_x4
        add(
            (x + 4 * dx <= W) & (y + 4 * dx + dy <= H) & (x - dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 4, dys, -1.0),
                (xs + dxs, ys + dxs, dxs * 2, dys, +2.0),
            ],
        )
        # tilted haar_y4
        add(
            (x + dx <= W) & (y + dx + 4 * dy <= H) & (x - 4 * dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, 4 * dys, -1.0),
                (xs - dys, ys + dys, dxs, 2 * dys, +2.0),
            ],
        )

    keys = np.concatenate([e[0] for e in entries])
    rects = np.concatenate(
        [e[1] for e in entries], axis=0, dtype=np.int32, casting="unsafe"
    )
    weights = np.concatenate(
        [np.broadcast_to(e[2], (e[1].shape[0], 3)) for e in entries], axis=0
    ).astype(np.float32)
    tilted = np.concatenate(
        [np.full((e[1].shape[0],), e[3], bool) for e in entries]
    )
    order = np.argsort(keys, kind="stable")
    return HaarCatalog(
        rects=rects[order],
        weights=weights[order],
        tilted=tilted[order],
        win_w=win_w,
        win_h=win_h,
        mode=mode,
    )


def eval_haar(sum_flat, tilted_flat, normfactor, offsets, weights, tilted_mask):
    """Haar responses for a batch of samples × a block of features.

    sum_flat    : (N, P) int32 flattened integral rows (P=(h+1)*(w+1))
    tilted_flat : (N, P) int32 or None when the block has no tilted features
    normfactor  : (N,) float32 per-sample normalization
    offsets     : (F, 3, 4) int corner offsets
    weights     : (F, 3) float32
    tilted_mask : (F,) bool or None
    returns     : (N, F) float32 — CvHaarEvaluator::operator()
                  (haarfeatures.h:108-122): Σ w_r·rectsum_r / nf, 0 if nf==0.
    """
    flat_idx = offsets.reshape(-1).long()

    def rectsums(img_flat):
        g = img_flat[:, flat_idx].reshape(img_flat.shape[0], offsets.shape[0], 3, 4)
        return g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]  # (N, F, 3)

    if tilted_flat is None or tilted_mask is None:
        rs = rectsums(sum_flat)
    else:
        rs = torch.where(tilted_mask[None, :, None], rectsums(tilted_flat), rectsums(sum_flat))
    # three exact small-integer products per feature: any order is exact
    resp = (rs.to(torch.float32) * weights[None]).sum(dim=2)
    nf = normfactor[:, None]
    return torch.where(nf != 0.0, resp / torch.where(nf == 0.0, 1.0, nf), 0.0)


# (row, col, bit) of the 8 outer cells: 128 at the top left, then clockwise
# around the centre (CvLBPEvaluator::Feature::calc)
LBP_BITS = ((0, 0, 128), (0, 1, 64), (0, 2, 32), (1, 2, 16),
            (2, 2, 8), (2, 1, 4), (2, 0, 2), (1, 0, 1))


def lbp_code_grid(cs):
    """3×3 grid of cell-sum tensors (row-major, any uniform shape) → LBP
    code tensor (int32): each outer cell sets its bit when its sum is
    >= the centre's. cs: indexable as cs[r][c]."""
    cval = cs[1][1]
    code = None
    for r, c, bit in LBP_BITS:
        t = torch.where(cs[r][c] >= cval, bit, 0).to(torch.int32)
        code = t if code is None else code | t
    return code


@dataclasses.dataclass
class LBPCatalog:
    """LBP features: rect (x, y, cell_w, cell_h) of the top-left cell of a
    3×3 grid, in reference order (lbpfeatures.cpp:35-45)."""

    rects: np.ndarray  # (F, 4) int32
    win_w: int
    win_h: int

    def __len__(self):
        return self.rects.shape[0]

    def cell_offsets(self) -> np.ndarray:
        """(F, 16) int32: the 16 grid-corner offsets of
        CvLBPEvaluator::Feature (lbpfeatures.cpp:53-63), a 4×4 grid of
        integral-image corners at x + {0, w, 2w, 3w}, y + {0, h, 2h, 3h},
        flattened row-major."""
        stride = self.win_w + 1
        x, y = self.rects[:, 0], self.rects[:, 1]
        w, h = self.rects[:, 2], self.rects[:, 3]
        cols = np.stack([x, x + w, x + 2 * w, x + 3 * w], axis=1)
        rows = np.stack([y, y + h, y + 2 * h, y + 3 * h], axis=1)
        return (cols[:, None, :] + stride * rows[:, :, None]).reshape(-1, 16).astype(np.int32)

    def cell_rects(self) -> np.ndarray:
        """(F, 9, 4) int32: the corner offsets (top left, top right, bottom
        left, bottom right) of the 9 cells, row-major over the 3×3 grid."""
        g = self.cell_offsets().reshape(-1, 4, 4)
        return np.stack([np.stack([g[:, r, c], g[:, r, c + 1], g[:, r + 1, c],
                                   g[:, r + 1, c + 1]], axis=1)
                         for r in range(3) for c in range(3)], axis=1)


def lbp_catalog(win_w: int, win_h: int) -> LBPCatalog:
    """Enumerate LBP features exactly as lbpfeatures.cpp:35-45 (loops over
    x, y, cell width, cell height)."""
    x = np.arange(win_w, dtype=np.int64)[:, None, None, None]
    y = np.arange(win_h, dtype=np.int64)[None, :, None, None]
    w = np.arange(1, win_w // 3 + 1, dtype=np.int64)[None, None, :, None]
    h = np.arange(1, win_h // 3 + 1, dtype=np.int64)[None, None, None, :]
    idx = np.nonzero((x + 3 * w <= win_w) & (y + 3 * h <= win_h))  # C order: x, y, w, h
    rects = np.stack([x.ravel()[idx[0]], y.ravel()[idx[1]], w.ravel()[idx[2]],
                      h.ravel()[idx[3]]], axis=1).astype(np.int32)
    return LBPCatalog(rects=rects, win_w=win_w, win_h=win_h)


def eval_lbp(sum_flat, p):
    """LBP codes for a batch of samples × a block of features.

    sum_flat : (N, P) int32 flattened integral rows
    p        : (F, 16) int grid corner offsets (LBPCatalog.cell_offsets)
    returns  : (N, F) int32 codes in [0, 255], CvLBPEvaluator::Feature::calc
               (lbpfeatures.h:70-83)."""
    g = sum_flat[:, p.reshape(-1).long()].reshape(sum_flat.shape[0], p.shape[0], 4, 4)
    cells = [[g[..., r, c] - g[..., r, c + 1] - g[..., r + 1, c] + g[..., r + 1, c + 1]
              for c in range(3)] for r in range(3)]
    return lbp_code_grid(cells)


# --------------------------------------------------------------------------
# HOG
# --------------------------------------------------------------------------

N_BINS = 9
N_CELLS = 4
HOG_FEAT_SIZE = N_BINS * N_CELLS  # 36


@dataclasses.dataclass
class HOGCatalog:
    """HOG block features: 2×2 cell grids (HOGfeatures.cpp:67-106).

    rects holds (x, y, cell_w, cell_h) of cell 0; the full block is
    (x, y, 2·cell_w, 2·cell_h). Each feature contributes 36 boosting
    variables (var = featureIdx·36 + cellIdx·9 + binIdx)."""

    rects: np.ndarray  # (F, 4) int32
    win_w: int
    win_h: int

    def __len__(self):
        return self.rects.shape[0]

    @property
    def var_count(self):
        return self.rects.shape[0] * HOG_FEAT_SIZE

    def cell_corner_offsets(self) -> np.ndarray:
        """(F, 4cells, 4corners) int32 offsets into flattened (h+1)(w+1)."""
        stride = self.win_w + 1
        x, y = self.rects[:, 0], self.rects[:, 1]
        w, h = self.rects[:, 2], self.rects[:, 3]
        cells = [(x, y), (x + w, y), (x, y + h), (x + w, y + h)]
        out = np.stack(
            [np.stack(sum_offsets(cx, cy, w, h, stride), axis=-1) for (cx, cy) in cells],
            axis=1,
        )
        return out.astype(np.int32)


def hog_catalog(win_w: int, win_h: int) -> HOGCatalog:
    """Enumerate HOG features exactly as HOGfeatures.cpp:67-106."""
    W, H = win_w, win_h
    rects = []
    t = 8
    while t <= W // 2:  # cell size
        for bw, bh, cw, ch in ((2 * t, 2 * t, t, t), (2 * t, 4 * t, t, 2 * t),
                               (4 * t, 2 * t, 2 * t, t)):
            for xx in range(0, W - bw + 1, 4):
                for yy in range(0, H - bh + 1, 4):
                    rects.append((xx, yy, cw, ch))
        t += 8
    arr = np.array(rects, np.int32).reshape(-1, 4) if rects else np.zeros((0, 4), np.int32)
    return HOGCatalog(rects=arr, win_w=win_w, win_h=win_h)
