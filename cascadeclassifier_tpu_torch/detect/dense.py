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
Haar arithmetic follows the JAX order op for op.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cascadeclassifier_tpu_torch.detect.integral import wrap_i32


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


def _stage_sum(stage, read_sum, read_tilt, inv_nf):
    """Σ leaves over one stage's stump trees, f32 (the JAX ``exact=False``
    mode): per tree raw = Σ f32(rect)·w in rect order (a tilted tree's
    rects from the tilted canvas), val = raw·inv_nf, leaf by val < thr,
    and the stage sum accumulated one add per tree, in tree order."""
    acc = torch.zeros_like(inv_nf)
    for i in range(stage.ntrees):
        tilted = bool(stage.tilted[i])
        read = read_tilt if tilted else read_sum
        if read is None:
            raise ValueError("a tilted tree needs the tilted canvas (tilt2d)")
        raw = None
        for r in range(3):
            wt = np.float32(stage.weights[i, r])
            if wt == 0.0:
                continue
            rx, ry, w, h = (int(v) for v in stage.feat_rects[i, r])
            term = _rect_sum(read, tilted, rx, ry, w, h).to(torch.float32) * float(wt)
            raw = term if raw is None else raw + term
        val = raw * inv_nf
        leaf = torch.where(
            val < float(np.float32(stage.thr[i])),
            float(np.float32(stage.left_leaf[i])),
            float(np.float32(stage.right_leaf[i])),
        )
        acc = acc + leaf.to(torch.float32)
    return acc


def dense_stage_haar(sum2d, stage, out_h, out_w, inv_nf, tilt2d=None):
    """The stage sum (``_stage_sum``) at every canvas position."""
    read_tilt = None if tilt2d is None else _dense_reader(tilt2d, out_h, out_w)
    return _stage_sum(stage, _dense_reader(sum2d, out_h, out_w), read_tilt, inv_nf)


def stage_pass(sum2d, stage, out_h, out_w, inv_nf, tilt2d=None):
    """Stage test: f32 stage sum ≥ f32 threshold (already lowered by 1e-5)."""
    ssum = dense_stage_haar(sum2d, stage, out_h, out_w, inv_nf, tilt2d)
    return ssum >= float(np.float32(stage.threshold))


def window_stage_pass(sum2d, tilt2d, stage, idx, out_w, inv_nf):
    """stage_pass at the windows of flat indices idx (r·out_w + c) only,
    with the same arithmetic; inv_nf (n,) f32 of those windows."""
    read_tilt = None if tilt2d is None else _window_reader(tilt2d, idx, out_w)
    ssum = _stage_sum(stage, _window_reader(sum2d, idx, out_w), read_tilt, inv_nf)
    return ssum >= float(np.float32(stage.threshold))


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
