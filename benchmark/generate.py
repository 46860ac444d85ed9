"""The benchmark's one traffic generator: every input a cell runs on,
made from ``--seed`` and the parameters of its traffic file.

A traffic file (``traffic/<name>.json``) names its ``kind``:

  - ``video``: a pool of ``pool`` distinct frames, cycled in a closed
    loop. Each frame is a synthetic face scene drawn at
    ``base_width`` x ``base_height`` (``faces`` blurred face blobs with
    eyes and a mouth on grey, ±8 noise) and enlarged ``upscale`` times
    by an exact integer bilinear resize. Every seed draws the same set
    of face sizes and grey levels, evenly spread over their ranges. The
    scenes come from the file's ``layout`` stream, the same for every
    seed; the seed orders them in the pool and draws each frame's noise,
    so every seed's pool holds the same work.
  - ``train``: ``corpora`` traincascade corpora, each a ``.vec`` of
    ``vec_count`` positive marks and ``backgrounds`` clutter frames with
    near-miss decoys, listed in a ``bg.txt``; they come from the
    ``layout`` stream, the same for every seed, and the seed orders them.

Integer-only numpy (a splitmix64 hash for the random numbers): the same
seed gives the same bytes on every machine. ``synth_scene`` with the
stream ``3 + k`` and no fixed sets is the scene the program's smoke
goldens were made on.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_U = np.uint64
_M64 = (1 << 64) - 1


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = x + _U(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)
    return x ^ (x >> _U(31))


def _key(stream: int, tag: int) -> int:
    """Counter base of (stream, tag); streams below 2^16 keep the layout
    ``(stream << 48) | (tag << 40)``, higher bits are hashed in."""
    key = ((stream & 0xFFFF) << 48) | (tag << 40)
    if stream >> 16:
        key ^= int(splitmix64(np.array([stream >> 16], dtype=np.uint64))[0])
    return key & _M64


def randint(stream: int, tag: int, n: int, lo: int, hi: int) -> np.ndarray:
    """n deterministic integers in [lo, hi) for (stream, tag)."""
    with np.errstate(over="ignore"):
        u = splitmix64(np.arange(n, dtype=np.uint64) + _U(_key(stream, tag)))
    return lo + (u % _U(hi - lo)).astype(np.int64)


def permutation(stream: int, tag: int, n: int) -> np.ndarray:
    """A deterministic permutation of range(n)."""
    with np.errstate(over="ignore"):
        u = splitmix64(np.arange(n, dtype=np.uint64) + _U(_key(stream, tag)))
    return np.argsort(u, kind="stable")


def spread(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers evenly spread over [lo, hi)."""
    return lo + (np.arange(n, dtype=np.int64) * (hi - lo)) // max(n, 1)


def _fill_ellipse(img, cx, cy, ax, ay, value):
    h, w = img.shape
    y0, y1 = max(cy - ay, 0), min(cy + ay + 1, h)
    x0, x1 = max(cx - ax, 0), min(cx + ax + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    dy = np.arange(y0, y1, dtype=np.int64)[:, None] - cy
    dx = np.arange(x0, x1, dtype=np.int64)[None, :] - cx
    inside = dx * dx * (ay * ay) + dy * dy * (ax * ax) <= (ax * ax) * (ay * ay)
    img[y0:y1, x0:x1][inside] = value


def _blur5(img: np.ndarray) -> np.ndarray:
    """Separable [1 4 6 4 1] binomial blur, edge-replicated, rounded."""
    k = (1, 4, 6, 4, 1)
    x = np.pad(img.astype(np.int64), 2, mode="edge")
    h, w = img.shape
    rows = sum(k[i] * x[:, i : i + w] for i in range(5))
    out = sum(k[i] * rows[i : i + h, :] for i in range(5))
    return ((out + 128) >> 8).astype(np.int64)


def synth_scene(stream: int, h: int = 1080, w: int = 1920, faces: int = 40,
                sizes=None, face_v=None, eye_v=None, mouth_v=None,
                noise_stream: int | None = None) -> np.ndarray:
    """(h, w) uint8: ``faces`` face blobs on grey, blurred, plus noise in
    [−8, 8). sizes, face_v, eye_v (two a face), mouth_v: fixed values;
    None draws them from the stream. The noise comes from noise_stream,
    or else from the stream."""
    img = np.full((h, w), 128, np.int64)
    m = faces
    cx = randint(stream, 1, m, 80, max(w - 80, 81))
    cy = randint(stream, 2, m, 80, max(h - 80, 81))
    s = randint(stream, 3, m, 25, 120) if sizes is None else np.asarray(sizes)
    fv = randint(stream, 4, m, 180, 230) if face_v is None else np.asarray(face_v)
    ev = randint(stream, 5, 2 * m, 30, 80) if eye_v is None else np.asarray(eye_v)
    mv = randint(stream, 6, m, 40, 90) if mouth_v is None else np.asarray(mouth_v)
    for i in range(m):
        x, y, si = int(cx[i]), int(cy[i]), int(s[i])
        _fill_ellipse(img, x, y, si, si * 5 // 4, int(fv[i]))
        for j, ex in enumerate((-1, 1)):
            r = max(2, si // 8)
            _fill_ellipse(img, x + ex * si // 3, y - si // 4, r, r, int(ev[2 * i + j]))
        _fill_ellipse(img, x, y + si // 2, si // 3, max(si // 8, 1), int(mv[i]))
    img = _blur5(img)
    noise = randint(stream if noise_stream is None else noise_stream, 7, h * w, -8, 8)
    noise = noise.reshape(h, w)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def substream(seed: int, k: int) -> int:
    """The k-th stream drawn from a seed (a run's seed or a traffic's layout)."""
    with np.errstate(over="ignore"):
        v = splitmix64(np.array([(int(seed) * 0x10001 + k) & _M64], dtype=np.uint64))
    return int(v[0])


def video_pool(t: dict, seed: int, resize) -> list:
    """The ``pool`` frames of a video traffic file, as (H, W) uint8 numpy
    arrays. The scenes come from the traffic's ``layout`` stream, the
    same for every seed: faces of ``face_size`` sizes and the grey levels
    spread evenly over their ranges. The seed orders the scenes in the
    pool and draws each frame's noise. resize(frame, w, h) enlarges a
    base frame (the reference's exact bilinear resize)."""
    n, m, lay = int(t["pool"]), int(t["faces"]), int(t["layout"])
    order = permutation(substream(lay, 1 << 20), 1, n * m)
    order2 = permutation(substream(lay, 1 << 20), 2, 2 * n * m)
    sizes = spread(n * m, *t["face_size"])[order].reshape(n, m)
    face_v = spread(n * m, *t["face_grey"])[order].reshape(n, m)
    mouth_v = spread(n * m, *t["mouth_grey"])[order].reshape(n, m)
    eye_v = spread(2 * n * m, *t["eye_grey"])[order2].reshape(n, 2 * m)
    frames = []
    for k, scene in enumerate(permutation(substream(seed, 1 << 20), 3, n)):
        base = synth_scene(substream(lay, int(scene)), int(t["base_height"]), int(t["base_width"]),
                           m, sizes[scene], face_v[scene], eye_v[scene], mouth_v[scene],
                           noise_stream=substream(seed, k))
        up = int(t["upscale"])
        frames.append(base if up == 1 else resize(base, base.shape[1] * up, base.shape[0] * up))
    return frames


# --------------------------------------------------------------- training


def _disc(yy, xx, cy, cx, r):
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _ring(yy, xx, cy, cx, r, t):
    d = (yy - cy) ** 2 + (xx - cx) ** 2
    return (d <= r * r) & (d >= (r - t) * (r - t))


def mark(size: int, card: int = 200, ink: int = 20, kind: int = -1, rng=None) -> np.ndarray:
    """(size, size) uint8 mark on its card: kind −1 the object, 0..5 its
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


def positives(n: int, win: int, seed: int) -> np.ndarray:
    """(n, win, win) uint8 marks: a dark ring and disc on a card, shifted
    up to 2.5 px, scaled 0.8–1.2, contrast 40–230 grey levels, ±24
    texture."""
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


def _blur3(img: np.ndarray) -> np.ndarray:
    p = np.pad(img.astype(np.int32), 1, mode="edge")
    h = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    v = h[:-2] + 2 * h[1:-1] + h[2:]
    return ((v + 8) >> 4).astype(np.uint8)


def background(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w) uint8 clutter: rectangle outlines, rings and bars on grey,
    and near-miss decoys of the mark, blurred."""
    rng = np.random.default_rng(seed)
    bg = np.full((h, w), 128, np.uint8)
    density = max(1, (h * w) // 880)
    for _ in range(density):
        x, y = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 40))
        s, g = int(rng.integers(8, 60)), int(rng.integers(0, 256))
        kind = int(rng.integers(0, 3))
        t = int(rng.integers(1, 5))
        x1, y1 = min(x + s, w), min(y + s, h)
        if kind == 0:
            bg[y:y + t, x:x1] = g
            bg[max(y1 - t, y):y1, x:x1] = g
            bg[y:y1, x:x + t] = g
            bg[y:y1, max(x1 - t, x):x1] = g
        elif kind == 1:
            r = s // 2
            y0, x0 = max(y - r, 0), max(x - r, 0)
            yy, xx = np.mgrid[y0:min(y + r + 1, h), x0:min(x + r + 1, w)]
            patch = bg[y0:y0 + yy.shape[0], x0:x0 + yy.shape[1]]
            patch[_ring(yy, xx, y, x, r, t)] = g
        else:
            bg[y:y + t, x:x1] = g
    for _ in range(max(1, density // 12)):
        ds = int(rng.integers(18, 80))
        x, y = int(rng.integers(0, w - ds)), int(rng.integers(0, h - ds))
        bg[y:y + ds, x:x + ds] = mark(ds, kind=int(rng.integers(0, 6)), rng=rng)
    return _blur3(bg)


def write_vec(path: str, samples: np.ndarray):
    """opencv_createsamples' .vec: count, sample area, two zero shorts,
    then each sample as a zero byte and its pixels as shorts."""
    n, h, w = samples.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iihh", n, h * w, 0, 0))
        body = np.zeros((n, 1 + 2 * h * w), np.uint8)
        body[:, 1:] = samples.reshape(n, -1).astype("<i2").view(np.uint8)
        f.write(body.tobytes())


def write_pgm(path: str, img: np.ndarray):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img, np.uint8).tobytes())


def train_corpora(t: dict, seed: int, out_dir: str) -> list:
    """Write a training traffic file's ``corpora`` corpora into out_dir
    and return them in the seed's order, each a dict of its ``.vec``,
    ``bg.txt`` and arrays. Corpus c holds ``vec_count`` positives drawn
    from the ``layout`` stream's c-th stream and the ``backgrounds``
    frames, shared by all, in its own order: the same corpora for every
    seed."""
    win, lay, n, nb = int(t["win"]), int(t["layout"]), int(t["vec_count"]), int(t["backgrounds"])
    frames, names = [], []
    for j in range(nb):
        img = background(int(t["bg_height"]), int(t["bg_width"]), substream(lay, (1 << 22) + j))
        names.append(os.path.join(out_dir, f"bg{j:03d}.pgm"))
        write_pgm(names[-1], img)
        frames.append(img)
    out = []
    for c in permutation(substream(seed, 1 << 21), 1, int(t["corpora"])):
        c = int(c)
        pos = positives(n, win, substream(lay, (1 << 21) + c))
        vec = os.path.join(out_dir, f"pos{c}.vec")
        write_vec(vec, pos)
        order = permutation(substream(lay, (1 << 21) + c), 2, nb)
        bg = os.path.join(out_dir, f"bg{c}.txt")
        with open(bg, "w") as f:
            f.write("".join(names[j] + "\n" for j in order))
        out.append(dict(index=c, vec=vec, bg=bg, positives=pos,
                        backgrounds=[frames[j] for j in order]))
    return out
