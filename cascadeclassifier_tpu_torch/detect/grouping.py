"""Exact replication of OpenCV groupRectangles.

The semantics of ``cascadeclassifier_tpu.detect.grouping``. Up to
NATIVE_MAX rects the port's host library groups them
(``data/native.py``, an all-pairs union-find in C++); beyond, numpy and
scipy do: the connected components go through scipy, which gives the
same classes, and the similar pairs come from an all-against-all test up
to DENSE_MAX rects and from k-d trees beyond, so that a frame's hundreds
of thousands of raw windows (a HOG cascade of a few stages at 1080p)
group in memory linear in the pairs. ``group_numpy`` is that path at
every size: the plain version the tests hold the library against.
``cv::groupRectangles(rectList, groupThreshold, eps)``:

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
from scipy.spatial import cKDTree


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


# Up to this many rects the all-against-all test is the quicker; beyond,
# the k-d search (on an H100 machine's host, 256 rects: 1.0 against 3.0
# ms; 320: 5.4 against 4.4; utils/time_grouping.py).
DENSE_MAX = 256


def similar_pairs(rects, eps: float = 0.2):
    """(i, j) index arrays of the pairs of rects that SimilarRects joins,
    each rect with itself among them: ``dense_pairs`` up to DENSE_MAX
    rects, ``kd_pairs`` beyond."""
    return (dense_pairs if len(rects) <= DENSE_MAX else kd_pairs)(rects, eps)


def dense_pairs(rects, eps: float = 0.2):
    """Every pair, both orders, by the all-against-all test: N² memory."""
    x, y, w, h = rects.T
    delta = eps * 0.5 * (np.minimum.outer(w, w) + np.minimum.outer(h, h))
    return np.nonzero(
        (np.abs(np.subtract.outer(x, x)) <= delta)
        & (np.abs(np.subtract.outer(y, y)) <= delta)
        & (np.abs(np.subtract.outer(x + w, x + w)) <= delta)
        & (np.abs(np.subtract.outer(y + h, y + h)) <= delta))


def kd_pairs(rects, eps: float = 0.2):
    """The same pairs (a pair of one size in both orders, of two sizes in
    one) in memory linear in them. Rects of one size form a group; two
    groups can hold similar rects only if their widths and heights differ
    by at most 2·delta (the x and the x + w sides both within delta), and
    between such groups the pairs are those within delta in the Chebyshev
    distance of (x, y, x + w, y + h), found by k-d trees."""
    x, y, w, h = rects.T
    pts = np.stack([x, y, x + w, y + h], axis=1).astype(np.float64)
    sizes, inv = np.unique(np.stack([w, h], axis=1), axis=0, return_inverse=True)
    members = [np.flatnonzero(inv.reshape(-1) == g) for g in range(len(sizes))]
    trees = [cKDTree(pts[m]) for m in members]
    rows, cols = [], []
    for a in range(len(sizes)):
        for b in range(a, len(sizes)):
            (wa, ha), (wb, hb) = sizes[a], sizes[b]
            delta = eps * 0.5 * (min(wa, wb) + min(ha, hb))
            if abs(int(wa) - int(wb)) > 2 * delta or abs(int(ha) - int(hb)) > 2 * delta:
                continue
            pairs = trees[a].sparse_distance_matrix(trees[b], delta, p=np.inf,
                                                    output_type="ndarray")
            rows.append(members[a][pairs["i"]])
            cols.append(members[b][pairs["j"]])
    return np.concatenate(rows), np.concatenate(cols)


# Up to this many rects the host library's O(N²) union-find is the
# quickest grouping; beyond, the k-d path (on an H100 machine's host,
# 2 560 rects: 14.5 against 17.4 ms; 3 072: 19.2 against 14.4;
# utils/time_grouping.py).
NATIVE_MAX = 2560


def group_rectangles(rects, group_threshold: int, eps: float = 0.2):
    """rects: (N, 4) int array-like of (x, y, w, h). Returns (M, 4) int32.

    Matches cv::groupRectangles(objects, minNeighbors, 0.2) as called by
    detectMultiScale. group_threshold <= 0 returns the input unchanged.
    Classes are the connected components of the similar pairs, in the
    order of their first member; a class's rect is the float32 average.
    Up to NATIVE_MAX rects the host library groups them, beyond it
    ``group_numpy``."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    if len(rects) <= NATIVE_MAX:
        from cascadeclassifier_tpu_torch.data.native import group_rectangles_native

        return group_rectangles_native(rects, group_threshold, eps)
    return group_numpy(rects, group_threshold, eps)


def group_numpy(rects, group_threshold: int, eps: float = 0.2, pairs=similar_pairs):
    """group_rectangles in numpy and scipy, the similar pairs from
    ``pairs`` (``similar_pairs``, or ``dense_pairs`` or ``kd_pairs`` at
    any size)."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    if group_threshold <= 0 or len(rects) == 0:
        return rects.astype(np.int32)

    n = len(rects)
    i, j = pairs(rects, eps)
    n_cls, labels = connected_components(
        csr_matrix((np.ones(len(i), bool), (i, j)), shape=(n, n)), directed=False)
    # label order is the order of each class's first member
    counts = np.bincount(labels, minlength=n_cls)
    sums = np.zeros((n_cls, 4), np.int64)
    np.add.at(sums, labels, rects)
    # OpenCV averages with float s = 1.f/n and FLOAT products
    s = np.float32(1.0) / counts.astype(np.float32)
    rrects = np.rint(sums.astype(np.float32) * s[:, None]).astype(np.int64)

    keep = np.flatnonzero(counts > group_threshold)
    r, cnt = rrects[keep], counts[keep]
    dx, dy = np.rint(r[:, 2] * eps).astype(np.int64), np.rint(r[:, 3] * eps).astype(np.int64)
    out = []
    for k in range(len(keep)):
        # r[k] inside a bigger class's rect (with its margin) is dropped
        inside = ((r[k, 0] >= r[:, 0] - dx) & (r[k, 1] >= r[:, 1] - dy)
                  & (r[k, 0] + r[k, 2] <= r[:, 0] + r[:, 2] + dx)
                  & (r[k, 1] + r[k, 3] <= r[:, 1] + r[:, 3] + dy)
                  & ((cnt > max(3, cnt[k])) | (cnt[k] < 3)))
        inside[k] = False
        if not inside.any():
            out.append(r[k])
    return np.array(out, np.int32).reshape(-1, 4)
