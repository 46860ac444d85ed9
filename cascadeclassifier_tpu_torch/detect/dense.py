"""Dense cascade evaluation over the pyramid canvas (plain PyTorch).

Counterpart of ``cascadeclassifier_tpu/detect/dense.py`` (which is XLA,
not Pallas, in the JAX package) and of ``engine.py::static_visit_grid``
/ ``parity_visited``. A rectangle sum is taken at every canvas position
at once from four shifted slices of the integral canvas; a window at
scaled coords (x, y) of level s lives at canvas position
(block_top[s] + y, x).

Exactness: corner differences run in int64 and are narrowed mod 2^32,
which recovers the true rect sum (it fits int32) whatever the wrapped
canvas values; f32 Haar arithmetic follows the JAX order op for op.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_rect_sum(c2d, rx, ry, w, h, out_h, out_w):
    """Rect sum at every canvas position → int64 (exact, non-negative)."""

    def sl(dy, dx):
        return c2d[dy : dy + out_h, dx : dx + out_w].to(torch.int64)

    s = sl(ry, rx) - sl(ry, rx + w) - sl(ry + h, rx) + sl(ry + h, rx + w)
    return s & 0xFFFFFFFF


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


def dense_stage_haar(sum2d, stage, out_h, out_w, inv_nf):
    """Σ leaves over one stage's untilted stump trees at every position,
    f32 (the JAX ``exact=False`` mode): per tree raw = Σ f32(rect)·w in
    rect order, val = raw·inv_nf, leaf by val < thr, and the stage sum
    accumulated one add per tree, in tree order."""
    acc = torch.zeros((out_h, out_w), dtype=torch.float32, device=sum2d.device)
    for i in range(stage.ntrees):
        raw = None
        for r in range(3):
            wt = np.float32(stage.weights[i, r])
            if wt == 0.0:
                continue
            rx, ry, w, h = (int(v) for v in stage.feat_rects[i, r])
            term = dense_rect_sum(sum2d, rx, ry, w, h, out_h, out_w).to(
                torch.float32
            ) * float(wt)
            raw = term if raw is None else raw + term
        val = raw * inv_nf
        leaf = torch.where(
            val < float(np.float32(stage.thr[i])),
            float(np.float32(stage.left_leaf[i])),
            float(np.float32(stage.right_leaf[i])),
        )
        acc = acc + leaf.to(torch.float32)
    return acc


def stage_pass(sum2d, stage, out_h, out_w, inv_nf):
    """Stage test: f32 stage sum ≥ f32 threshold (already lowered by 1e-5)."""
    ssum = dense_stage_haar(sum2d, stage, out_h, out_w, inv_nf)
    return ssum >= float(np.float32(stage.threshold))


def static_visit_grid(plan) -> np.ndarray:
    """(out_h, out_w) bool — the superset of window positions the OpenCV
    x-walk can visit: grid rows (ystep-aware), columns within the level
    bound, even columns where ystep == 2."""
    out_h, out_w = plan.out_h, plan.out_w
    cols = np.arange(out_w)
    return (
        plan.row_is_grid[:out_h, None]
        & (cols[None, :] <= plan.row_maxc[:out_h, None])
        & (~plan.row_step2[:out_h, None] | ((cols[None, :] & 1) == 0))
    )


def parity_visited(m0, on, ordinal=None):
    """Closed form of OpenCV's serial x-walk with skip-after-reject.

    Per row, over its sequence of `on` columns c_1 < c_2 < …, the walk is
    v_k = ¬(v_{k−1} ∧ m0[c_{k−1}]), v_1 = True; hence
        v_k = even(k − lastFalse_k − 1)
    with lastFalse_k the ordinal of the last on-column before k where the
    skip trigger m0 was False (an exclusive prefix max, via cummax).

    m0, on: (H, W) bool; ordinal: optional inclusive int32 cumsum of on."""
    if ordinal is None:
        ordinal = torch.cumsum(on.to(torch.int32), dim=1, dtype=torch.int32)
    marker = torch.where(on & ~m0, ordinal, torch.zeros_like(ordinal))
    lastf = torch.cummax(marker, dim=1).values
    lastf = torch.cat(
        [torch.zeros_like(lastf[:, :1]), lastf[:, :-1]], dim=1
    )
    return on & (((ordinal - lastf - 1) & 1) == 0)
