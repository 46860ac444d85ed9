"""Synthetic training data for the trainer's smoke run (numpy only).

The object is the training benchmark's mark: a dark ring and a dark disc
on a mid-grey card. ``positives`` renders it at window size with a
per-sample shift, scale, contrast and texture jitter; ``background``
draws a clutter frame of rectangles, rings and bars on grey, with
near-miss decoys of the mark (ring only, disc only, a shifted disc, the
polarity inverted, a bar across it, a thin ring) so that every stage
mines hard negatives; ``write_pgm`` and ``write_png`` write a binary PGM
and an 8-bit grayscale PNG the port's image reader decodes without cv2. Integer-only and seeded: the same call gives
the same bytes on every machine.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _disc(yy, xx, cy, cx, r):
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _ring(yy, xx, cy, cx, r, t):
    d = (yy - cy) ** 2 + (xx - cx) ** 2
    return (d <= r * r) & (d >= (r - t) * (r - t))


def mark(size: int, card: int = 200, ink: int = 20, kind: int = -1, rng=None) -> np.ndarray:
    """(size, size) uint8 mark on its card: kind -1 the object, 0..5 its
    decoys (ring only, disc only, shifted disc, inverted, barred, thin)."""
    s = size / 48.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) + 0.5
    c = size / 2.0
    img = np.full((size, size), card, np.int32)
    ring_t = (2 if kind == 5 else 4) * s
    if kind != 1:
        img[_ring(yy, xx, c, c, 19 * s, ring_t)] = ink
    if kind != 0:
        dy = dx = 0.0
        if kind == 2:
            dy, dx = (float(v) * s for v in rng.integers(2, 7, 2))
        img[_disc(yy, xx, c + dy, c + dx, (6 if kind == 5 else 9) * s)] = ink
    if kind == 3:
        img = 220 - img
    if kind == 4:
        o = int(rng.integers(10, 38) * s)
        img[o:o + max(1, int(6 * s))] = int(rng.integers(90, 170))
    return np.clip(img, 0, 255).astype(np.uint8)


def positives(n: int, win: int = 24, seed: int = 0) -> np.ndarray:
    """(n, win, win) uint8 marks with a shift of up to 2.5 px, a scale of
    0.8-1.2, card and ink levels that vary the contrast from 40 to 230
    grey levels, and ±24 texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:win, 0:win].astype(np.float64) + 0.5
    out = np.empty((n, win, win), np.uint8)
    for i in range(n):
        s = win / 48.0 * rng.uniform(0.8, 1.2)
        cy, cx = win / 2.0 + rng.uniform(-2.5, 2.5, 2)
        ink = int(rng.integers(0, 90))
        card = ink + int(rng.integers(40, 231 - ink))
        img = np.full((win, win), card, np.int32)
        img[_ring(yy, xx, cy, cx, 19 * s, 4 * s)] = ink
        img[_disc(yy, xx, cy, cx, 9 * s)] = ink
        img += rng.integers(-24, 25, (win, win))
        out[i] = np.clip(img, 0, 255)
    return out


def _blur(img: np.ndarray) -> np.ndarray:
    """[1 2 1]/4 both ways, integer, edges replicated."""
    p = np.pad(img.astype(np.int32), 1, mode="edge")
    h = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    v = h[:-2] + 2 * h[1:-1] + h[2:]
    return ((v + 8) >> 4).astype(np.uint8)


def background(h: int = 1080, w: int = 1920, seed: int = 0, marks: int = 0):
    """(h, w) uint8 clutter frame; with marks > 0 it also holds that many
    true marks (18-96 px) and returns (frame, [(x, y, size), ...])."""
    rng = np.random.default_rng(seed)
    bg = np.full((h, w), 128, np.uint8)
    density = max(1, (h * w) // 880)
    for _ in range(density):
        x, y = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 40))
        s, g = int(rng.integers(8, 60)), int(rng.integers(0, 256))
        kind = int(rng.integers(0, 3))
        t = int(rng.integers(1, 5))
        x1, y1 = min(x + s, w), min(y + s, h)
        if kind == 0:  # rectangle outline
            bg[y:y + t, x:x1] = g
            bg[max(y1 - t, y):y1, x:x1] = g
            bg[y:y1, x:x + t] = g
            bg[y:y1, max(x1 - t, x):x1] = g
        elif kind == 1:  # ring around (x, y)
            r = s // 2
            y0, x0 = max(y - r, 0), max(x - r, 0)
            yy, xx = np.mgrid[y0:min(y + r + 1, h), x0:min(x + r + 1, w)]
            patch = bg[y0:y0 + yy.shape[0], x0:x0 + yy.shape[1]]
            patch[_ring(yy, xx, y, x, r, t)] = g
        else:  # bar
            bg[y:y + t, x:x1] = g
    for _ in range(max(1, density // 12)):  # near-miss decoys
        ds = int(rng.integers(18, 80))
        x, y = int(rng.integers(0, w - ds)), int(rng.integers(0, h - ds))
        bg[y:y + ds, x:x + ds] = mark(ds, kind=int(rng.integers(0, 6)), rng=rng)
    placed = []
    for _ in range(marks):
        ds = int(rng.integers(18, 97))
        x, y = int(rng.integers(0, w - ds)), int(rng.integers(0, h - ds))
        bg[y:y + ds, x:x + ds] = mark(ds)
        placed.append((x, y, ds))
    bg = _blur(bg)
    return (bg, placed) if marks else bg


def write_pgm(path: str, img: np.ndarray):
    """Binary PGM (P5)."""
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img, np.uint8).tobytes())


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """8-bit grayscale PNG, row y filtered with PNG filter type y mod 5
    (None, Sub, Up, Average, Paeth), so that a reader meets every filter."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    x = img.astype(np.int32)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    rows = bytearray()
    for y in range(h):
        f = y % 5
        rows.append(f)
        rows += ((x[y] - preds[f][y]) & 0xFF).astype(np.uint8).tobytes()
    with open(path, "wb") as out:
        out.write(b"\x89PNG\r\n\x1a\n"
                  + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                  + _png_chunk(b"IDAT", zlib.compress(bytes(rows)))
                  + _png_chunk(b"IEND", b""))
