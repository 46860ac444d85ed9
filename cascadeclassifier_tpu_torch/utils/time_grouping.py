"""Times the groupings of ``detect/grouping.py`` on detection-like rect
sets of growing size, to place ``NATIVE_MAX`` and ``DENSE_MAX``: the host
library's union-find (``data/native.py``), and the numpy grouping with the
all-against-all pair search (``dense_pairs``) and with the k-d tree one
(``kd_pairs``); and the two pair searches alone.

    python3 -m cascadeclassifier_tpu_torch.utils.time_grouping [--sizes 64,256,...]

Needs no card: grouping runs on the host, so the times are the host's
that runs it (the first call builds the host library with g++). A set of
N rects is what a detector's raw windows look like: square boxes of a
24-pixel window scaled by 1.1 a level (30 levels), around N / 40 objects
placed in a 1920x1080 frame (seed 0), each rect at a level near its
object's size, offset by up to a fifth of its box. Per size: the number
of distinct box sizes, each grouping's median ms over the repetitions at
group threshold 3 (dense only up to --dense-upto rects: it takes N²
memory), the pair searches' ms, and that every path gives the same rects
in the same order and both searches the same pairs. The last line is one
JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from cascadeclassifier_tpu_torch.data.native import group_rectangles_native
from cascadeclassifier_tpu_torch.detect.grouping import (
    DENSE_MAX,
    NATIVE_MAX,
    dense_pairs,
    group_numpy,
    kd_pairs,
)


def detection_like(n: int, seed: int = 0) -> np.ndarray:
    """(n, 4) int64 rects (x, y, w, h) shaped like a frame's raw windows."""
    rng = np.random.default_rng(seed)
    boxes = np.rint(24 * 1.1 ** np.arange(30)).astype(np.int64)
    n_obj = max(1, n // 40)
    level = rng.integers(3, 27, n_obj)
    cx, cy = rng.integers(0, 1920, n_obj), rng.integers(0, 1080, n_obj)
    obj = rng.integers(0, n_obj, n)
    w = boxes[np.clip(level[obj] + rng.integers(-3, 4, n), 0, len(boxes) - 1)]
    jit = np.maximum(w // 5, 1)
    x = cx[obj] - w // 2 + rng.integers(-jit, jit + 1)
    y = cy[obj] - w // 2 + rng.integers(-jit, jit + 1)
    return np.stack([x, y, w, w], axis=1)


def pair_set(ij, n: int) -> np.ndarray:
    """The unordered pairs of (i, j) as sorted codes min·n + max."""
    i, j = (np.asarray(a, np.int64) for a in ij)
    return np.unique(np.minimum(i, j) * n + np.maximum(i, j))


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def measure(sizes, thr: int = 3, reps: int = 20, dense_upto: int = 4096) -> list:
    """Per size, one printed line and one row: box sizes, groups, each
    grouping's median ms (group_native_ms, group_dense_ms, group_kd_ms)
    and each pair search's alone (dense_ms, kd_ms), the dense ones None
    beyond dense_upto rects, and whether every path agrees."""
    rows = []
    for n in sizes:
        rects = detection_like(n)
        r = reps if n <= 4096 else max(3, reps // 4)
        dense = n <= dense_upto
        want = group_numpy(rects, thr, pairs=kd_pairs)
        got = [group_rectangles_native(rects, thr)]
        if dense:
            got.append(group_numpy(rects, thr, pairs=dense_pairs))
        same = all(np.array_equal(g, want) for g in got)
        if dense:
            same = same and bool(np.array_equal(pair_set(dense_pairs(rects), n),
                                                pair_set(kd_pairs(rects), n)))
        row = {"n": n, "sizes": int(len(np.unique(rects[:, 2]))), "groups": int(len(want)),
               "group_native_ms": median_ms(lambda: group_rectangles_native(rects, thr), r),
               "group_dense_ms": median_ms(lambda: group_numpy(rects, thr, pairs=dense_pairs),
                                           r) if dense else None,
               "group_kd_ms": median_ms(lambda: group_numpy(rects, thr, pairs=kd_pairs), r),
               "dense_ms": median_ms(lambda: dense_pairs(rects), r) if dense else None,
               "kd_ms": median_ms(lambda: kd_pairs(rects), r), "same": same}
        rows.append(row)

        def f(v):
            return "      n/a" if v is None else f"{v:9.3f}"

        print(f"n {n:6d}  box sizes {row['sizes']:3d}  groups {row['groups']:4d}  grouping: "
              f"native {f(row['group_native_ms'])} ms  dense {f(row['group_dense_ms'])} ms  "
              f"k-d {f(row['group_kd_ms'])} ms  (pair search: dense {f(row['dense_ms'])}, "
              f"k-d {f(row['kd_ms'])})  same {same}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="16,32,64,128,256,512,1024,2048,4096")
    ap.add_argument("--reps", type=int, default=20,
                    help="repetitions up to 4096 rects; a quarter of them beyond")
    ap.add_argument("--dense-upto", type=int, default=4096)
    ap.add_argument("--threshold", type=int, default=3)
    args = ap.parse_args(argv)
    print(f"NATIVE_MAX {NATIVE_MAX}, DENSE_MAX {DENSE_MAX}; group threshold {args.threshold}; "
          f"median ms over {args.reps} calls after one")
    rows = measure([int(v) for v in args.sizes.split(",")], args.threshold, args.reps,
                   args.dense_upto)
    print(json.dumps({"native_max": NATIVE_MAX, "dense_max": DENSE_MAX,
                      "threshold": args.threshold, "rows": rows}))
    return 0 if all(r["same"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
