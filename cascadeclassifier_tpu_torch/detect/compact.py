"""Survivor extraction and the per-window tail (plain PyTorch).

Counterpart of the survivor extraction (``make_nonzero_fn`` /
``make_block_nonzero_fn``) and the tail (``make_tail_compact_fn``) of
``cascadeclassifier_tpu/detect/compact.py``. The TPU's tail evaluates
rect sums as bf16 limb matmuls against corner-incidence matrices; here
the tail reads the int32 patches directly:

  per stage, per tree (vectorized over windows and trees):
    rect  = 4 corner columns of the patch, int64, narrowed mod 2^32
    raw   = f32(rect0)·w0 + f32(rect1)·w1 + f32(rect2)·w2   (rect order;
            a rect of weight 0 has zero area and adds +0)
    val   = raw·inv_nf;  leaf = val < thr ? left : right
  stage sum: one add per tree, in tree order (not torch.sum, whose
  reduction order differs), in f32 or (exact, the JAX tail's acc_dt) in
  f64 from leaves widened before each add, then ssum ≥ threshold; the
  live windows are compacted after every stage.

Extraction syncs with the host once per frame for the survivor count,
and each tail stage three times (its boolean indexes); there is no
static capacity and so no overflow fallback. Each tail stage is a span,
``engine.tail_stage``.
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count, span


def extract_survivors(alive):
    """(out_h, out_w) bool → ascending flat int64 indices of set positions."""
    count(SYNC)
    return torch.nonzero(alive.reshape(-1)).squeeze(1)


class TailTables:
    """Per-stage corner columns and tree constants for one window size,
    held on one device."""

    def __init__(self, cascade, stage_ids, device):
        pw = cascade.win_w + 1
        self.stages = []
        for si in stage_ids:
            st = cascade.stages[si]
            fr = st.feat_rects.astype(np.int64)  # (T, 3, 4) x, y, w, h
            x, y, w, h = fr[..., 0], fr[..., 1], fr[..., 2], fr[..., 3]
            corners = np.stack(
                [y * pw + x, y * pw + x + w, (y + h) * pw + x, (y + h) * pw + x + w]
            )  # (4, T, 3) patch columns

            def dev(a, dt):
                return torch.as_tensor(a, dtype=dt, device=device)

            self.stages.append(dict(
                corners=dev(corners, torch.int64),
                weights=dev(st.weights, torch.float32),
                thr=dev(st.thr, torch.float32),
                left=dev(st.left_leaf, torch.float32),
                right=dev(st.right_leaf, torch.float32),
                threshold=float(np.float32(st.threshold)),
                ntrees=st.ntrees,
            ))


def tail(patches, inv_nf, tables: TailTables, exact: bool = False):
    """patches (n, P) int32, inv_nf (n,) f32 → indices (ascending, int64)
    of the windows that pass every stage of ``tables``, with f32 or
    (exact) f64 stage sums."""
    acc_dt = torch.float64 if exact else torch.float32
    keep = torch.arange(patches.shape[0], device=patches.device)
    for st in tables.stages:
        if keep.numel() == 0:
            break
        with span("engine.tail_stage"):
            p = patches.to(torch.int64)
            c = st["corners"]
            rect = (p[:, c[0]] - p[:, c[1]] - p[:, c[2]] + p[:, c[3]]) & 0xFFFFFFFF
            rf = rect.to(torch.float32)  # (n, T, 3), rounds as f32(int32) does
            w = st["weights"]
            raw = rf[:, :, 0] * w[:, 0]
            raw = raw + rf[:, :, 1] * w[:, 1]
            raw = raw + rf[:, :, 2] * w[:, 2]
            val = raw * inv_nf[:, None]
            leaf = torch.where(val < st["thr"], st["left"], st["right"])
            ssum = leaf[:, 0].to(acc_dt, copy=True)
            for t in range(1, st["ntrees"]):
                ssum += leaf[:, t]
            ok = ssum >= st["threshold"]
            count(SYNC, 3)  # each boolean index waits for its count
            patches, inv_nf, keep = patches[ok], inv_nf[ok], keep[ok]
    return keep
