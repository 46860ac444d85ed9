"""Synthetic face frames made with integer-only numpy.

Haar face cascades fire on "face blobs" (a bright ellipse with dark eye
blobs and a mouth, blurred); plain noise fires no window. Every step here
is integer arithmetic (a splitmix64 hash for the random numbers, integer
ellipse tests, a binomial blur with integer rounding), so a frame is
byte-identical on any machine and numpy version; no OpenCV is needed.
"""

from __future__ import annotations

import numpy as np

_U = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x + _U(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)
    return x ^ (x >> _U(31))


def _randint(seed: int, tag: int, n: int, lo: int, hi: int) -> np.ndarray:
    """n deterministic integers in [lo, hi) for (seed, tag)."""
    ctr = np.arange(n, dtype=np.uint64) + _U((int(seed) << 48) | (int(tag) << 40))
    u = _splitmix64(ctr)
    return (lo + (u % _U(hi - lo)).astype(np.int64)).astype(np.int64)


def _fill_ellipse(img, cx, cy, ax, ay, value):
    """Fill the ellipse (x−cx)²/ax² + (y−cy)²/ay² ≤ 1 (integer test)."""
    h, w = img.shape
    y0, y1 = max(cy - ay, 0), min(cy + ay + 1, h)
    x0, x1 = max(cx - ax, 0), min(cx + ax + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    dy = np.arange(y0, y1, dtype=np.int64)[:, None] - cy
    dx = np.arange(x0, x1, dtype=np.int64)[None, :] - cx
    inside = dx * dx * (ay * ay) + dy * dy * (ax * ax) <= (ax * ax) * (ay * ay)
    img[y0:y1, x0:x1][inside] = value


def _blur(img: np.ndarray) -> np.ndarray:
    """Separable [1 4 6 4 1] binomial blur, edge-replicated, rounded."""
    k = (1, 4, 6, 4, 1)
    x = np.pad(img.astype(np.int64), 2, mode="edge")
    h, w = img.shape
    rows = sum(k[i] * x[:, i : i + w] for i in range(5))  # (h+4, w)
    out = sum(k[i] * rows[i : i + h, :] for i in range(5))
    return ((out + 128) >> 8).astype(np.int64)


N_FACES = 40


def synth_frame(k: int = 0, h: int = 1080, w: int = 1920) -> np.ndarray:
    """(h, w) uint8 frame number k: N_FACES face blobs on grey, blurred,
    plus uniform noise in [−8, 8)."""
    img = np.full((h, w), 128, np.int64)
    seed = 3 + int(k)
    m = N_FACES
    cx = _randint(seed, 1, m, 80, max(w - 80, 81))
    cy = _randint(seed, 2, m, 80, max(h - 80, 81))
    s = _randint(seed, 3, m, 25, 120)
    face_v = _randint(seed, 4, m, 180, 230)
    eye_v = _randint(seed, 5, 2 * m, 30, 80)
    mouth_v = _randint(seed, 6, m, 40, 90)
    for i in range(m):
        x, y, si = int(cx[i]), int(cy[i]), int(s[i])
        _fill_ellipse(img, x, y, si, si * 5 // 4, int(face_v[i]))
        for j, ex in enumerate((-1, 1)):
            r = max(2, si // 8)
            _fill_ellipse(img, x + ex * si // 3, y - si // 4, r, r, int(eye_v[2 * i + j]))
        _fill_ellipse(img, x, y + si // 2, si // 3, max(si // 8, 1), int(mouth_v[i]))
    img = _blur(img)
    noise = _randint(seed, 7, h * w, -8, 8).reshape(h, w)
    return np.clip(img + noise, 0, 255).astype(np.uint8)
