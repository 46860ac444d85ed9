"""Times the two similar-pair searches of ``detect/grouping.py`` (the
all-against-all ``dense_pairs`` and the k-d tree ``kd_pairs``) on
detection-like rect sets of growing size, to place ``DENSE_MAX``.

    python3 -m cascadeclassifier_tpu_torch.utils.time_grouping [--sizes 64,256,...]

Needs no card: grouping runs on the host, so the times are the host's
that runs it. A set of N rects is what a detector's raw windows look
like: square boxes of a 24-pixel window scaled by 1.1 a level (30
levels), around N / 40 objects placed in a 1920x1080 frame (seed 0),
each rect at a level near its object's size, offset by up to a fifth of
its box. Per size: the number of distinct box sizes, each search's
median ms over the repetitions, and that both give the same pairs.
The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from cascadeclassifier_tpu_torch.detect.grouping import DENSE_MAX, dense_pairs, kd_pairs


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="16,32,64,128,256,512,1024,2048,4096")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    rows = []
    print(f"DENSE_MAX {DENSE_MAX}; median ms over {args.reps} calls after one")
    for n in (int(v) for v in args.sizes.split(",")):
        rects = detection_like(n)
        same = bool(np.array_equal(pair_set(dense_pairs(rects), n),
                                   pair_set(kd_pairs(rects), n)))
        row = {"n": n, "sizes": int(len(np.unique(rects[:, 2]))),
               "dense_ms": median_ms(lambda: dense_pairs(rects), args.reps),
               "kd_ms": median_ms(lambda: kd_pairs(rects), args.reps), "same_pairs": same}
        rows.append(row)
        print(f"n {n:6d}  box sizes {row['sizes']:3d}  dense {row['dense_ms']:9.3f} ms  "
              f"k-d {row['kd_ms']:9.3f} ms  same pairs {same}", flush=True)
    print(json.dumps({"dense_max": DENSE_MAX, "rows": rows}))
    return 0 if all(r["same_pairs"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
