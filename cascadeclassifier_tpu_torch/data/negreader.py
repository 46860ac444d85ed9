"""Deterministic multi-scale background-window miner (numpy only).

A copy of ``cascadeclassifier_tpu.data.negreader``. Replicates the
reference NegReader schedule exactly (imagestorage.cpp:23-126):
round-robin over the bg list with a round-counter-derived start offset,
windows slid by stepFactor=0.5·win, then scale ·= √2 and rescan, then the
next image. Resizes use the bit-exact INTER_LINEAR_EXACT copy
(ops/resize.py), so every window is byte-identical to the reference's.

``level_positions``/``skip``/``state`` give the trainer's dense miner
whole (image, scale) levels; the schedule is independent of the
cascade's decisions, so mining a level at a time selects the same
windows as the reference's one-window-per-predict loop
(cascadeclassifier.cpp:329-357). A level's positions come as a
``GridRun``: the run of its grid's windows in O(1), an array on demand.

The default image reader, ``imread_gray``, decodes binary PGM (P5) and
8-bit grayscale PNG with numpy and zlib, and hands any other file to
``cv2`` where ``cv2`` imports.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from cascadeclassifier_tpu_torch.ops.resize import resize_linear_exact_np

SCALE_FACTOR = np.float32(1.4142135623730950488016887242097)
STEP_FACTOR = np.float32(0.5)


def _read_pgm(data: bytes) -> np.ndarray:
    """Binary PGM (P5, maxval < 256): header tokens separated by
    whitespace, '#' comments to the end of a line, one whitespace byte
    before the raster."""
    tokens, i = [], 2
    while len(tokens) < 3:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while data[i:i + 1] not in (b"\n", b"\r", b""):
                i += 1
            continue
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        tokens.append(int(data[i:j]))
        i = j
    w, h, maxval = tokens
    if maxval >= 256:
        raise ValueError("16-bit PGM")
    i += 1  # the single whitespace byte after maxval
    return np.frombuffer(data, np.uint8, w * h, i).reshape(h, w).copy()


def _paeth_row(raw: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = np.zeros_like(raw)
    a = 0
    for x in range(raw.shape[0]):
        b = int(prev[x])
        c = int(prev[x - 1]) if x else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (int(raw[x]) + pred) & 0xFF
        out[x] = a
    return out


def _read_png_gray8(data: bytes) -> np.ndarray:
    """8-bit grayscale, non-interlaced PNG: IDAT chunks inflated with zlib,
    each scanline unfiltered (None, Sub, Up, Average, Paeth)."""
    pos, idat, w = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or color != 0 or interlace != 0:
                raise ValueError("not an 8-bit grayscale non-interlaced PNG")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if w is None:
        raise ValueError("PNG without IHDR")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        f, raw = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = raw.copy()
        elif f == 1:
            cur = (np.cumsum(raw, dtype=np.int64) & 0xFF).astype(np.uint8)
        elif f == 2:
            cur = raw + prev
        elif f == 3:
            cur = np.zeros(w, np.uint8)
            a = 0
            for x in range(w):
                a = (int(raw[x]) + ((a + int(prev[x])) >> 1)) & 0xFF
                cur[x] = a
        elif f == 4:
            cur = _paeth_row(raw, prev)
        else:
            raise ValueError(f"PNG filter type {f}")
        out[y] = cur
        prev = cur
    return out


def imread_gray(path: str):
    """Grayscale uint8 image, or None when the file cannot be read (as
    ``cv2.imread(path, 0)``). PGM P5 and 8-bit grayscale PNG are decoded
    here; any other file goes to cv2, and raises if cv2 is absent."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        if data[:2] == b"P5":
            return _read_pgm(data)
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            return _read_png_gray8(data)
    except ValueError:
        pass
    try:
        import cv2
    except ImportError:
        raise ValueError(
            f"{path}: only PGM (P5) and 8-bit grayscale PNG are read without cv2"
        ) from None
    return cv2.imread(path, 0)


def read_bg_list(path: str):
    """bg.txt parsing (imagestorage.cpp:35-55): '#' comments skipped, an
    empty line terminates the list."""
    names = []
    with open(path) as f:
        for line in f:
            s = line.rstrip(" \n\r\t")
            if not s:
                break
            if s[0] == "#":
                continue
            names.append(s)
    return names


class LazyLevel:
    """A scheduled (image, scale) level whose resized pixels materialize
    on first host access.

    Device-side dense mining builds the level ON-CHIP from the uploaded
    source (gather-resize twin of resize_linear_exact), so for most
    levels the host never resizes at all — only levels that contribute
    accepted windows pay the exact host resize (the crop in
    CascadeTrainer._fill_negatives). At late-stage acceptance (< 1e-4)
    that removes ~all host resize wall-clock from the mining loop."""

    __slots__ = ("src", "src_id", "w", "h", "_img")

    def __init__(self, src, src_id, w, h):
        self.src = src
        self.src_id = src_id
        self.w, self.h = int(w), int(h)
        self._img = None

    @property
    def shape(self):
        return (self.h, self.w)

    @property
    def size(self):
        return self.h * self.w

    def materialize(self) -> np.ndarray:
        if self._img is None:
            self._img = resize_linear_exact_np(self.src, self.w, self.h)
        return self._img

    def __getitem__(self, sl):
        return self.materialize()[sl]

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return np.asarray(a, dtype=dtype)


class GridRun:
    """A level's positions as a run of its window grid: count windows from
    grid index first, window k at q = first + k, (px, py) = (ox + (q % nx)
    · sx, oy + (q // nx) · sy). Array-like on demand, as ``LazyLevel`` is
    for pixels: ``len``, indexing and ``np.asarray`` give the (count, 2)
    int32 array of the JAX package's ``level_positions``, byte for byte
    (an element ``pos[i, j]`` without building it); ``train/mine.py::
    pack_levels`` reads the fields and never the array."""

    __slots__ = ("ox", "oy", "sx", "sy", "nx", "first", "count", "_pos")

    def __init__(self, ox, oy, sx, sy, nx, first, count):
        self.ox, self.oy, self.sx, self.sy = int(ox), int(oy), int(sx), int(sy)
        self.nx, self.first, self.count = int(nx), int(first), int(count)
        self._pos = None

    def __len__(self):
        return self.count

    @property
    def shape(self):
        return (self.count, 2)

    @property
    def materialized(self) -> bool:
        return self._pos is not None

    def materialize(self) -> np.ndarray:
        if self._pos is None:
            q = self.first + np.arange(self.count, dtype=np.int64)
            self._pos = np.stack([self.ox + (q % self.nx) * self.sx,
                                  self.oy + (q // self.nx) * self.sy], 1).astype(np.int32)
        return self._pos

    def __getitem__(self, key):
        if (isinstance(key, tuple) and len(key) == 2 and self._pos is None
                and all(isinstance(k, (int, np.integer)) for k in key)):
            i, j = int(key[0]), int(key[1])
            if not -self.count <= i < self.count or not -2 <= j < 2:
                raise IndexError(f"index {key} out of bounds for shape {self.shape}")
            q = self.first + i % self.count
            return np.int32(self.ox + (q % self.nx) * self.sx if j % 2 == 0
                            else self.oy + (q // self.nx) * self.sy)
        return self.materialize()[key]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.materialize(), dtype=dtype)


class NegReader:
    """Streaming negative miner; ``get()`` yields one (h, w) uint8 window.

    lazy=True: scheduled levels are LazyLevel descriptors (shape-only on
    the host); the schedule arithmetic needs only sizes, so the exact
    resize runs on-device during dense mining and on-host only for
    accepted-window crops."""

    def __init__(self, bg_path: str, win_w: int, win_h: int, imread=None,
                 lazy: bool = False):
        self.filenames = read_bg_list(bg_path)
        if not self.filenames:
            raise FileNotFoundError(f"no backgrounds in {bg_path}")
        self.win_w, self.win_h = win_w, win_h
        self.src = None  # full-res gray image
        self.img = None  # current scaled image
        self.point = (0, 0)
        self.offset = (0, 0)
        self.scale = np.float32(1.0)
        self.last = 0
        self.round = 0
        self.lazy = lazy
        self.src_id = -1
        self._raw_imread = imread_gray if imread is None else imread
        self._src_cache = {}

    # decoded-source cache: the round-robin schedule re-reads every
    # background once per pass — hundreds of passes at late-stage
    # acceptance re-decode the same files (the reference re-imreads too,
    # imagestorage.cpp:57-88, but pays it in its own wall-clock)
    SRC_CACHE_CAP = 256

    def _imread(self, path):
        img = self._src_cache.get(path)
        if img is None:
            img = self._raw_imread(path)
            if img is not None and len(self._src_cache) < self.SRC_CACHE_CAP:
                self._src_cache[path] = img
        return img

    def _resize(self, w, h):
        if self.lazy:
            return LazyLevel(self.src, self.src_id, w, h)
        return resize_linear_exact_np(self.src, w, h)

    # -- schedule (mirrors NegReader::nextImg / ::get) ----------------------

    def _next_img(self) -> bool:
        count = len(self.filenames)
        src = None
        off = (0, 0)
        for _ in range(count):
            src = self._imread(self.filenames[self.last])
            src_id = self.last
            self.last += 1
            if src is None or src.size == 0:
                self.last %= count
                src = None
                continue
            self.round += self.last // count
            self.round %= self.win_w * self.win_h
            self.last %= count
            ox = min(self.round % self.win_w, src.shape[1] - self.win_w)
            oy = min(self.round // self.win_w, src.shape[0] - self.win_h)
            if src.ndim == 2 and ox >= 0 and oy >= 0:
                off = (ox, oy)
                break
            src = None
        if src is None:
            return False
        self.src = src
        self.src_id = src_id
        self.point = self.offset = off
        rows, cols = src.shape
        self.scale = np.float32(
            max(
                np.float32(self.win_w + off[0]) / np.float32(cols),
                np.float32(self.win_h + off[1]) / np.float32(rows),
            )
        )
        sz_w = int(self.scale * cols + 0.5)
        sz_h = int(self.scale * rows + 0.5)
        self.img = self._resize(sz_w, sz_h)
        return True

    def _advance(self) -> bool:
        """Move ``point`` past the current window (imagestorage.cpp:105-124),
        crossing level / image boundaries. False when backgrounds run out."""
        ww, wh = self.win_w, self.win_h
        px, py = self.point
        if int(px + (1.0 + STEP_FACTOR) * ww) < self.img.shape[1]:
            self.point = (px + int(STEP_FACTOR * ww), py)
        else:
            px0 = self.offset[0]
            if int(py + (1.0 + STEP_FACTOR) * wh) < self.img.shape[0]:
                self.point = (px0, py + int(STEP_FACTOR * wh))
            else:
                self.point = (px0, self.offset[1])
                self.scale = np.float32(self.scale * SCALE_FACTOR)
                if self.scale <= 1.0:
                    rows, cols = self.src.shape
                    self.img = self._resize(
                        int(self.scale * cols), int(self.scale * rows)
                    )
                else:
                    if not self._next_img():
                        return False
        return True

    def get(self):
        """Next window, or None when no usable background exists."""
        if self.img is None:
            if not self._next_img():
                return None
        ww, wh = self.win_w, self.win_h
        px, py = self.point
        win = self.img[py : py + wh, px : px + ww].copy()
        if not self._advance():
            return None
        return win

    # -- level-granular access for device-side dense mining -----------------

    def state(self):
        """Snapshot of the schedule state (images by reference)."""
        return (self.src, self.img, self.point, self.offset, self.scale,
                self.last, self.round, self.src_id)

    def set_state(self, st):
        (self.src, self.img, self.point, self.offset, self.scale,
         self.last, self.round, self.src_id) = st

    def level_positions(self):
        """The remaining windows of the current (image, scale) level:
        ``(img, positions)`` with positions a ``GridRun``, array-like
        (m, 2) int32 ``(px, py)`` in schedule order starting at the
        current point. Does NOT advance state — pair with ``skip(k)``.
        None when backgrounds run out.

        With these two plus ``state``/``set_state``, hard-negative mining
        evaluates whole levels on-device (one small image upload instead
        of per-window crops) while preserving the reference's exact
        window schedule (imagestorage.cpp:90-126)."""
        if self.img is None and not self._next_img():
            return None
        ww, wh = self.win_w, self.win_h
        H, W = self.img.shape
        sx, sy = int(STEP_FACTOR * ww), int(STEP_FACTOR * wh)
        px0 = self.offset[0]
        xs = [px0]
        while int(xs[-1] + (1.0 + STEP_FACTOR) * ww) < W:
            xs.append(xs[-1] + sx)
        ys = [self.point[1]]
        while int(ys[-1] + (1.0 + STEP_FACTOR) * wh) < H:
            ys.append(ys[-1] + sy)
        n_first = sum(1 for x in xs if x >= self.point[0])  # a suffix of xs
        return self.img, GridRun(px0, ys[0], sx, sy, len(xs), len(xs) - n_first,
                                 n_first + (len(ys) - 1) * len(xs))

    def skip(self, k: int) -> bool:
        """Advance the schedule by k windows (no cropping).

        Equivalent to k repeated ``_advance()`` calls but O(levels)
        instead of O(k): positions within the current level come from
        the same grid arithmetic as level_positions, and level/image
        crossings reuse ``_advance`` from the level's last window (late-
        stage mining skips millions of windows per stage — the per-
        window Python walk was the round-3 mining wall)."""
        if self.img is None and not self._next_img():
            return False
        ww, wh = self.win_w, self.win_h
        while k > 0:
            H, W = self.img.shape
            sx, sy = int(STEP_FACTOR * ww), int(STEP_FACTOR * wh)
            px0 = self.offset[0]
            xs = [px0]
            while int(xs[-1] + (1.0 + STEP_FACTOR) * ww) < W:
                xs.append(xs[-1] + sx)
            ys = [self.point[1]]
            while int(ys[-1] + (1.0 + STEP_FACTOR) * wh) < H:
                ys.append(ys[-1] + sy)
            first = [x for x in xs if x >= self.point[0]]
            n_rem = len(first) + (len(ys) - 1) * len(xs)
            if n_rem == 0:  # defensive: no window at point
                if not self._advance():
                    return False
                k -= 1
                continue
            if k < n_rem:
                if k < len(first):
                    self.point = (first[k], ys[0])
                else:
                    j = k - len(first)
                    self.point = (xs[j % len(xs)], ys[1 + j // len(xs)])
                return True
            # cross the level: stand on its last window, advance once
            last_x = xs[-1] if len(ys) > 1 else first[-1]
            self.point = (last_x, ys[-1])
            k -= n_rem
            if not self._advance():
                return False
        return True

    def take_batch(self, n: int) -> np.ndarray:
        """Next n schedule windows as (m, win_h, win_w) uint8, m ≤ n."""
        out = np.empty((n, self.win_h, self.win_w), np.uint8)
        m = 0
        for i in range(n):
            w = self.get()
            if w is None:
                break
            out[m] = w
            m += 1
        return out[:m]
