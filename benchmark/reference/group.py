"""cv::groupRectangles(rects, groupThreshold, eps=0.2), plain numpy.

Written from OpenCV 4.x's source (cascadedetect.cpp): classes are the
connected components of the SimilarRects relation, numbered in the
order of their first rect; each class is averaged with float32
products and rounded half to even; classes of groupThreshold rects or
fewer go, and so does a class inside a bigger one it does not
outnumber. Rects are tested pair by pair in blocks of rows.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

EPS = 0.2
_BLOCK = 2048


def _similar_pairs(r: np.ndarray, eps: float):
    x, y, w, h = (r[:, i].astype(np.float64) for i in range(4))
    rows, cols = [], []
    for a in range(0, len(r), _BLOCK):
        sl = slice(a, a + _BLOCK)
        delta = eps * (np.minimum.outer(w[sl], w) + np.minimum.outer(h[sl], h)) * 0.5
        near = ((np.abs(np.subtract.outer(x[sl], x)) <= delta)
                & (np.abs(np.subtract.outer(y[sl], y)) <= delta)
                & (np.abs(np.subtract.outer(x[sl] + w[sl], x + w)) <= delta)
                & (np.abs(np.subtract.outer(y[sl] + h[sl], y + h)) <= delta))
        i, j = np.nonzero(near)
        rows.append(i + a)
        cols.append(j)
    return np.concatenate(rows), np.concatenate(cols)


def group_rectangles(rects, group_threshold: int, eps: float = EPS) -> np.ndarray:
    r = np.asarray(rects, np.int64).reshape(-1, 4)
    if group_threshold <= 0 or len(r) == 0:
        return r.astype(np.int32)
    i, j = _similar_pairs(r, eps)
    graph = coo_matrix((np.ones(len(i), np.int8), (i, j)), shape=(len(r), len(r)))
    _, comp = connected_components(graph, directed=False)
    # number the classes in the order their first rect appears
    _, first = np.unique(comp, return_index=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    labels = rank[comp]
    n = np.bincount(labels)
    sums = np.stack([np.bincount(labels, weights=r[:, k]).astype(np.int64) for k in range(4)], 1)
    s = (np.float32(1.0) / n.astype(np.float32)).astype(np.float32)
    avg = np.rint(sums.astype(np.float32) * s[:, None]).astype(np.int64)
    out = []
    for a in range(len(n)):
        n1 = n[a]
        if n1 <= group_threshold:
            continue
        x1, y1, w1, h1 = avg[a]
        inside = False
        for b in range(len(n)):
            n2 = n[b]
            if b == a or n2 <= group_threshold:
                continue
            x2, y2, w2, h2 = avg[b]
            dx, dy = int(np.rint(w2 * EPS)), int(np.rint(h2 * EPS))
            if (x1 >= x2 - dx and y1 >= y2 - dy and x1 + w1 <= x2 + w2 + dx
                    and y1 + h1 <= y2 + h2 + dy and (n2 > max(3, n1) or n1 < 3)):
                inside = True
                break
        if not inside:
            out.append(avg[a])
    return np.asarray(out, np.int32).reshape(-1, 4)
