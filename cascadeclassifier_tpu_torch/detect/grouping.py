"""Exact replication of OpenCV groupRectangles (numpy + scipy).

A copy of ``cascadeclassifier_tpu.detect.grouping`` without the native
C++ dispatch (the connected components go through scipy, which gives the
same classes). ``cv::groupRectangles(rectList, groupThreshold, eps)``:

  - partition rects into connected components under the SimilarRects
    predicate (|Δ| ≤ eps · 0.5 · (min(w1,w2) + min(h1,h2)) on all 4 sides)
  - average each class (cvRound = round-half-even, float32 products)
  - keep classes with count > groupThreshold, dropping small clusters
    contained in bigger ones
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components


def _cv_round(v):
    return int(np.rint(v))


def clip_rects(rects, img_w: int, img_h: int):
    """Clip rects to the image, dropping empty intersections.

    Replicates OpenCV's clipObjects, which detectMultiScale applies AFTER
    groupRectangles: candidates at the last pyramid level can overhang
    the image by a pixel, and the overhang takes part in the cluster
    average before the clip."""
    rects = np.asarray(rects, np.int32).reshape(-1, 4)
    if len(rects) == 0:
        return rects
    x = np.maximum(rects[:, 0], 0)
    y = np.maximum(rects[:, 1], 0)
    w = np.minimum(rects[:, 0] + rects[:, 2], img_w) - x
    h = np.minimum(rects[:, 1] + rects[:, 3], img_h) - y
    keep = (w > 0) & (h > 0)
    return np.stack([x, y, w, h], axis=1)[keep]


def group_rectangles(rects, group_threshold: int, eps: float = 0.2):
    """rects: (N, 4) int array-like of (x, y, w, h). Returns (M, 4) int32.

    Matches cv::groupRectangles(objects, minNeighbors, 0.2) as called by
    detectMultiScale. group_threshold <= 0 returns the input unchanged."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    if group_threshold <= 0 or len(rects) == 0:
        return rects.astype(np.int32)

    x, y, w, h = rects.T
    delta = eps * 0.5 * (np.minimum.outer(w, w) + np.minimum.outer(h, h))
    sim = (
        (np.abs(np.subtract.outer(x, x)) <= delta)
        & (np.abs(np.subtract.outer(y, y)) <= delta)
        & (np.abs(np.subtract.outer(x + w, x + w)) <= delta)
        & (np.abs(np.subtract.outer(y + h, y + h)) <= delta)
    )
    _, roots = connected_components(csr_matrix(sim), directed=False)
    classes = {}
    for i, r in enumerate(roots):
        classes.setdefault(r, []).append(i)

    rrects = []
    rweights = []
    for members in classes.values():
        # OpenCV averages with float s = 1.f/n and FLOAT products
        s = np.float32(1.0) / np.float32(len(members))
        acc = rects[members].sum(axis=0).astype(np.float32)
        rrects.append(tuple(_cv_round(acc[k] * s) for k in range(4)))
        rweights.append(len(members))

    out = []
    for i, (r1, n1) in enumerate(zip(rrects, rweights)):
        if n1 <= group_threshold:
            continue
        contained = False
        for j, (r2, n2) in enumerate(zip(rrects, rweights)):
            if j == i or n2 <= group_threshold:
                continue
            dx = _cv_round(r2[2] * eps)
            dy = _cv_round(r2[3] * eps)
            if (
                r1[0] >= r2[0] - dx
                and r1[1] >= r2[1] - dy
                and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                and r1[1] + r1[3] <= r2[1] + r2[3] + dy
                and (n2 > max(3, n1) or n1 < 3)
            ):
                contained = True
                break
        if not contained:
            out.append(r1)
    return np.array(out, np.int32).reshape(-1, 4)
