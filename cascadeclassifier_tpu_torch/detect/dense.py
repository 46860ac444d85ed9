"""Dense cascade evaluation over the pyramid canvas (plain PyTorch).

Counterpart of ``cascadeclassifier_tpu/detect/dense.py`` (which is XLA,
not Pallas, in the JAX package) and of ``engine.py::static_visit_grid``
/ ``parity_visited``. A rectangle sum is taken at every canvas position
at once from four shifted slices of the integral canvas (or of the
tilted canvas, ``canvas_tilted``); a window at scaled coords (x, y) of
level s lives at canvas position (block_top[s] + y, x).

Exactness: corner differences run in int64 and are narrowed to int32
mod 2^32, as the JAX package's int32 arithmetic wraps. That recovers the
true rect sum (it fits int32) whatever the wrapped canvas values, and
gives JAX's value too at a window that straddles two pyramid blocks,
where a tilted "sum" across the block top's reset can be negative; f32
Haar arithmetic follows the JAX order op for op. The stage sum is f32
(``exact=False``) or f64 (``exact=True``, the JAX package's default and
OpenCV's runtime): each tree's f32 leaf is widened before its add, one
add a tree in tree order from 0, and the test is sum ≥ the threshold
widened from f32.

Three stage forms, as the JAX package's: stump Haar (``dense_stage_haar``),
categorical LBP stumps (``dense_stage_lbp``) and node trees of either
feature (``dense_stage_deep``, for a stage with any tree of more than one
internal node); ``stage_sum`` picks one. Each takes a corner reader, so
the same code runs at every canvas position (the ``dense_*`` forms) and
gathered at a list of windows (``window_stage_pass``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cascadeclassifier_tpu_torch.detect.integral import wrap_i32
from cascadeclassifier_tpu_torch.ops.features import lbp_code_grid


def _narrow_i32(x):
    """int64 → its int32 value mod 2^32 (two's complement), kept int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _dense_reader(c2d, out_h, out_w):
    """Corner reader at every canvas position: (dy, dx) → int64 slice."""
    return lambda dy, dx: c2d[dy : dy + out_h, dx : dx + out_w].to(torch.int64)


def _window_reader(c2d, idx, out_w):
    """Corner reader at the windows of flat indices idx (r·out_w + c):
    (dy, dx) → int64 gather."""
    cw = c2d.shape[1]
    base = (idx // out_w) * cw + idx % out_w
    flat = c2d.reshape(-1)
    return lambda dy, dx: flat[base + (dy * cw + dx)].to(torch.int64)


def _rect_sum(read, tilted: bool, rx, ry, w, h):
    """Upright: C[y][x] − C[y][x+w] − C[y+h][x] + C[y+h][x+w]. Tilted
    (CV_TILTED_OFFSETS): p0 = (x, y), p1 = (x−h, y+h), p2 = (x+w, y+w),
    p3 = (x+w−h, y+w+h); p0 − p1 − p2 + p3. PackedCascade checks at pack
    time that every corner lies inside the window, so every offset is
    non-negative."""
    if tilted:
        if rx - h < 0:
            raise ValueError("tilted rect escapes the window (x − h < 0)")
        s = (read(ry, rx) - read(ry + h, rx - h) - read(ry + w, rx + w)
             + read(ry + w + h, rx + w - h))
    else:
        s = read(ry, rx) - read(ry, rx + w) - read(ry + h, rx) + read(ry + h, rx + w)
    return _narrow_i32(s)


def dense_rect_sum(c2d, rx, ry, w, h, out_h, out_w):
    """Rect sum at every canvas position → int64 (exact)."""
    return _rect_sum(_dense_reader(c2d, out_h, out_w), False, rx, ry, w, h)


def dense_tilted_rect_sum(t2d, rx, ry, w, h, out_h, out_w):
    """Tilted rect sum at every canvas position → int64 (exact)."""
    return _rect_sum(_dense_reader(t2d, out_h, out_w), True, rx, ry, w, h)


def dense_variance_gate(sum2d, sq2d, win_w, win_h, out_h, out_w):
    """OpenCV HaarEvaluator::setWindow gate at every position.

    nf² = area·Σx² − (Σx)² in int64, 1/√nf² in f64 narrowed to f32, and
    the window passes iff nf² > 0 and area·inv < 0.1 (in f64).
    Returns (gate bool, inv_nf f32), both (out_h, out_w); inv_nf is 1
    where the gate fails."""
    rw, rh = win_w - 2, win_h - 2
    area = rw * rh
    vs = dense_rect_sum(sum2d, 1, 1, rw, rh, out_h, out_w)
    vq = dense_rect_sum(sq2d, 1, 1, rw, rh, out_h, out_w)
    nf2 = area * vq - vs * vs
    pos = nf2 > 0
    nf = torch.sqrt(torch.where(pos, nf2, 1).to(torch.float64))
    inv_nf = (1.0 / nf).to(torch.float32)
    ok = pos & ((float(area) * inv_nf.to(torch.float64)) < 1e-1)
    return ok, torch.where(ok, inv_nf, torch.ones_like(inv_nf))


def _haar_value(read, tilted: bool, rects, inv_nf):
    """One Haar feature's normalized value: raw = Σ f32(rect)·w in rect
    order (from the tilted canvas for a tilted feature), raw·inv_nf.
    rects: (x, y, w, h, weight) of the weighted rects."""
    if read is None:
        raise ValueError("a tilted tree needs the tilted canvas (tilt2d)")
    raw = None
    for rx, ry, w, h, wt in rects:
        term = (_rect_sum(read, tilted, int(rx), int(ry), int(w), int(h)).to(torch.float32)
                * float(np.float32(wt)))
        raw = term if raw is None else raw + term
    return raw * inv_nf


def _lbp_code(read, rect):
    """LBP code of one feature (its top-left cell rect (x, y, w, h)) →
    int32: the 9 cell sums as int32 values, compared signed."""
    x, y, w, h = (int(v) for v in rect)
    return lbp_code_grid([[_rect_sum(read, False, x + c * w, y + r * h, w, h)
                           for c in range(3)] for r in range(3)])


def _subset_left(code, subsets):
    """The categorical split: bit (code & 31) of subsets[code >> 5]."""
    words = torch.as_tensor(np.asarray(subsets, np.int32), device=code.device)
    return ((words[(code >> 5).long()] >> (code & 31)) & 1) != 0


def _leaf(go_left, left, right):
    return torch.where(go_left, float(np.float32(left)), float(np.float32(right))).to(torch.float32)


def _stump_leaves(stage, lbp: bool, read_sum, read_tilt, inv_nf):
    """Each stump tree's f32 leaf at the windows, in tree order."""
    for i in range(stage.ntrees):
        if lbp:
            go_left = _subset_left(_lbp_code(read_sum, stage.lbp_rects[i]), stage.subsets[i])
        else:
            tilted = bool(stage.tilted[i])
            rects = [(*stage.feat_rects[i, r], stage.weights[i, r]) for r in range(3)
                     if stage.weights[i, r] != 0]
            val = _haar_value(read_tilt if tilted else read_sum, tilted, rects, inv_nf)
            go_left = val < float(np.float32(stage.thr[i]))
        yield _leaf(go_left, stage.left_leaf[i], stage.right_leaf[i])


def _node_left(tree, k: int, f, lbp: bool, read_sum, read_tilt, inv_nf):
    """Node k of a node tree (feature f) at the windows: True where the
    split sends a window left (LBP: its subset bit; Haar: value < thr)."""
    if lbp:
        return _subset_left(_lbp_code(read_sum, f.rect), tree.subsets[k])
    val = _haar_value(read_tilt if f.tilted else read_sum, bool(f.tilted), f.rects, inv_nf)
    return val < float(np.float32(tree.threshold[k]))


def _deep_leaves(stage, lbp: bool, read_sum, read_tilt, inv_nf):
    """Each node tree's f32 leaf at the windows, in tree order: every node
    evaluated at every window and the paths taken by selects (the JAX
    package's predictOrdered / predictCategorical semantics); a child code
    c <= 0 is leaf −c, c > 0 node c."""
    for tree, feats in stage.deep_trees:

        def node(k):
            go_left = _node_left(tree, k, feats[k], lbp, read_sum, read_tilt, inv_nf)
            sides = []
            for c in (int(tree.left[k]), int(tree.right[k])):
                sides.append(float(np.float32(tree.leaf_values[-c])) if c <= 0 else node(c))
            return torch.where(go_left, *sides).to(torch.float32)

        yield node(0)


def node_visits(stage, read_sum, read_tilt, inv_nf, lbp: bool = False) -> dict:
    """How many times the windows of the readers visit a node in the
    stage's trees, by the node feature's count of weighted rects (0 for
    LBP): every window takes each tree's root, and a node below it only
    where the path from the root leads there (the kernels' walk, counted
    with the twin's arithmetic). inv_nf: f32 of the windows' shape."""
    n = inv_nf.numel()
    counts: dict = {}

    def add(k, visits):
        counts[k] = counts.get(k, 0) + visits

    if stage.deep_trees is None:
        for i in range(stage.ntrees):
            add(0 if lbp else int((stage.weights[i] != 0).sum()), n)
        return counts
    for tree, feats in stage.deep_trees:
        todo = [(0, torch.ones(inv_nf.shape, dtype=torch.bool, device=inv_nf.device))]
        while todo:
            k, at = todo.pop()
            f = feats[k]
            add(0 if lbp else sum(1 for r in f.rects if r[4] != 0), int(at.sum()))
            go_left = _node_left(tree, k, f, lbp, read_sum, read_tilt, inv_nf)
            for c, side in ((int(tree.left[k]), go_left), (int(tree.right[k]), ~go_left)):
                if c > 0:
                    todo.append((c, at & side))
    return counts


def window_node_visits(sum2d, tilt2d, stage, idx, out_w, inv_nf, lbp: bool = False) -> dict:
    """node_visits at the windows of flat indices idx (r·out_w + c);
    inv_nf (n,) f32 of those windows, or None for LBP."""
    if inv_nf is None:
        inv_nf = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    read_tilt = None if tilt2d is None else _window_reader(tilt2d, idx, out_w)
    return node_visits(stage, _window_reader(sum2d, idx, out_w), read_tilt, inv_nf, lbp)


def stage_sum(stage, read_sum, read_tilt, inv_nf, lbp: bool = False, exact: bool = False):
    """Σ leaves over one stage at the windows of the readers: node trees
    when the stage has any, else stumps (Haar, or LBP when lbp); f32, or
    f64 when exact (each leaf widened before its add). inv_nf: f32 of the
    windows' shape (any values for LBP, which reads none)."""
    acc_dt = torch.float64 if exact else torch.float32
    trees = _deep_leaves if stage.deep_trees is not None else _stump_leaves
    acc = torch.zeros(inv_nf.shape, dtype=acc_dt, device=inv_nf.device)
    for leaf in trees(stage, lbp, read_sum, read_tilt, inv_nf):
        acc = acc + leaf.to(acc_dt)
    return acc


def _passes(ssum, stage):
    """ssum ≥ the stage threshold (f32, already lowered by 1e-5), compared
    in the sum's type."""
    return ssum >= float(np.float32(stage.threshold))


def _ones(out_h, out_w, device):
    return torch.ones((out_h, out_w), dtype=torch.float32, device=device)


def dense_stage_haar(sum2d, stage, out_h, out_w, inv_nf, tilt2d=None, exact=False):
    """Σ leaves over one stage's stump Haar trees (node 0 of each, for a
    node-tree stage, as the JAX package's) at every canvas position."""
    read_tilt = None if tilt2d is None else _dense_reader(tilt2d, out_h, out_w)
    return stage_sum(dataclasses.replace(stage, deep_trees=None),
                     _dense_reader(sum2d, out_h, out_w), read_tilt, inv_nf, exact=exact)


def dense_stage_lbp(sum2d, stage, out_h, out_w, exact=False):
    """Σ leaves over one stage's categorical LBP stumps at every position."""
    return stage_sum(dataclasses.replace(stage, deep_trees=None),
                     _dense_reader(sum2d, out_h, out_w), None,
                     _ones(out_h, out_w, sum2d.device), lbp=True, exact=exact)


def dense_stage_deep(sum2d, tilt2d, stage, out_h, out_w, inv_nf, is_haar, exact=False):
    """Σ leaves over one stage's node trees at every position (Haar when
    is_haar, else LBP; inv_nf may be None for LBP)."""
    if inv_nf is None:
        inv_nf = _ones(out_h, out_w, sum2d.device)
    read_tilt = None if tilt2d is None else _dense_reader(tilt2d, out_h, out_w)
    return stage_sum(stage, _dense_reader(sum2d, out_h, out_w), read_tilt, inv_nf,
                     lbp=not is_haar, exact=exact)


def stage_pass(sum2d, stage, out_h, out_w, inv_nf, tilt2d=None, exact=False, lbp=False):
    """Stage test at every canvas position: the stage sum (f32, or f64
    when exact) ≥ the threshold; inv_nf may be None for LBP."""
    if inv_nf is None:
        inv_nf = _ones(out_h, out_w, sum2d.device)
    read_tilt = None if tilt2d is None else _dense_reader(tilt2d, out_h, out_w)
    ssum = stage_sum(stage, _dense_reader(sum2d, out_h, out_w), read_tilt, inv_nf, lbp, exact)
    return _passes(ssum, stage)


def window_stage_pass(sum2d, tilt2d, stage, idx, out_w, inv_nf, exact=False, lbp=False):
    """stage_pass at the windows of flat indices idx (r·out_w + c) only,
    with the same arithmetic; inv_nf (n,) f32 of those windows (None for
    LBP)."""
    if inv_nf is None:
        inv_nf = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    read_tilt = None if tilt2d is None else _window_reader(tilt2d, idx, out_w)
    ssum = stage_sum(stage, _window_reader(sum2d, idx, out_w), read_tilt, inv_nf, lbp, exact)
    return _passes(ssum, stage)


def canvas_tilted(px, is_top, pad: int):
    """Tilted (45°) integral of every pyramid block of the pixel canvas:
    the plain twin of kernel ``tilted`` (``detect/tilted.py``).

    px: (H, W) int32 pixel canvas (zero block-top rows, zero first
    column); is_top: (H,) bool block-top rows (the plan's numpy array);
    pad: the recurrence runs on columns [−pad, W+pad) with zeros
    outside, and a boundary error moves inward one column per row, so
    columns [0, W) come out exact when pad ≥ the tallest block's rows − 2
    (the JAX package passes max scaled_h + 1). Returns (H, W) int32, per
    block the layout of cv2.integral3's tilted output with row stride W.

    A row loop, as the JAX ``lax.scan``: with T[y] the row y of the
    result on the padded columns and I[y][x] = px[y][x] (0 outside
    1 ≤ x < W),
        T[y][x] = T[y−1][x−1] + T[y−1][x+1] − T[y−2][x] + I[y][x] + I[y−1][x]
    with I[y−1] dropped when row y−1 is a block top, and T[y] = 0 (both
    carries reset) at a block top. int64, masked to 32 bits every row,
    narrowed to int32 at the end."""
    h, w = px.shape
    tops = np.asarray(is_top, bool)
    if tops.shape != (h,):
        raise ValueError(f"is_top has shape {tops.shape}, expected ({h},)")
    rows = torch.zeros((h, w + 2 * pad), dtype=torch.int64, device=px.device)
    rows[:, pad + 1 : pad + w] = px[:, 1:]
    out = torch.zeros((h, w), dtype=torch.int64, device=px.device)
    t1 = t2 = torch.zeros(w + 2 * pad, dtype=torch.int64, device=px.device)
    for y in range(h):
        if tops[y]:
            t1 = t2 = torch.zeros_like(t1)
            continue
        t = F.pad(t1[:-1], (1, 0)) + F.pad(t1[1:], (0, 1)) - t2 + rows[y]
        if y > 0 and not tops[y - 1]:
            t = t + rows[y - 1]
        t1, t2 = t & 0xFFFFFFFF, t1
        out[y] = t1[pad : pad + w]
    return wrap_i32(out)


def static_visit_grid(plan) -> np.ndarray:
    """(out_h, out_w) bool — the superset of window positions the OpenCV
    x-walk can visit: grid rows (ystep-aware), columns within the level
    bound, even columns where ystep == 2 (a shelf-packed plan's grid2d)."""
    if plan.packed:
        return plan.grid2d
    out_h, out_w = plan.out_h, plan.out_w
    cols = np.arange(out_w)
    return (
        plan.row_is_grid[:out_h, None]
        & (cols[None, :] <= plan.row_maxc[:out_h, None])
        & (~plan.row_step2[:out_h, None] | ((cols[None, :] & 1) == 0))
    )


def parity_visited(m0, on, ordinal=None, reset=None):
    """Closed form of OpenCV's serial x-walk with skip-after-reject.

    Per row, over its sequence of `on` columns c_1 < c_2 < …, the walk is
    v_k = ¬(v_{k−1} ∧ m0[c_{k−1}]), v_1 = True; hence
        v_k = even(k − lastFalse_k − 1)
    with lastFalse_k the ordinal of the last on-column before k where the
    skip trigger m0 was False (an exclusive prefix max, via cummax).

    m0, on: (H, W) bool; ordinal: optional inclusive int32 cumsum of on;
    reset: optional (H, W) bool, columns that restart the walk as a fresh
    row would (the gaps between levels that share a shelf-packed row): a
    reset column carries the ordinal of the on-column before it, which
    makes the next on-column visited."""
    if ordinal is None:
        ordinal = torch.cumsum(on.to(torch.int32), dim=1, dtype=torch.int32)
    zero = torch.zeros_like(ordinal)
    marker = torch.where(on & ~m0, ordinal, zero)
    if reset is not None:
        marker = torch.maximum(marker, torch.where(reset, ordinal, zero))
    lastf = torch.cummax(marker, dim=1).values
    lastf = torch.cat(
        [torch.zeros_like(lastf[:, :1]), lastf[:, :-1]], dim=1
    )
    return on & (((ordinal - lastf - 1) & 1) == 0)
