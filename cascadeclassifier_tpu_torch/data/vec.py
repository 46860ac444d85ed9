""".vec positive-sample file I/O (numpy only).

A copy of ``cascadeclassifier_tpu.data.vec``: the port imports nothing of
the JAX package. Binary format (reference imagestorage.cpp:138-182,
utility.cpp:128-152):

  header : int32 count, int32 vecSize, int16 tmp, int16 tmp  (little-endian)
  record : uchar pad(=0), vecSize × int16 pixel values (row-major)

The whole file decodes to a (count, h, w) uint8 array in one shot; a thin
cursor class keeps the reference's consume/restart/error semantics for
the trainer.
"""

from __future__ import annotations

import numpy as np

_HEADER = np.dtype(
    [("count", "<i4"), ("vecsize", "<i4"), ("_t1", "<i2"), ("_t2", "<i2")]
)


class VecError(RuntimeError):
    pass


def read_vec(path: str, width: int | None = None, height: int | None = None):
    """Decode a .vec file → (count, h, w) uint8 (or (count, vecsize) when the
    window shape is unknown)."""
    raw = np.fromfile(path, np.uint8)
    if raw.size < 12:
        raise VecError(f"{path}: truncated vec header")
    hdr = raw[:12].view(_HEADER)[0]
    count, vecsize = int(hdr["count"]), int(hdr["vecsize"])
    rec = 1 + 2 * vecsize
    body = raw[12:]
    if body.size < count * rec:
        raise VecError(f"{path}: vec body too short ({body.size} < {count}*{rec})")
    body = body[: count * rec].reshape(count, rec)
    out = body[:, 1:].copy().view("<i2").reshape(count, vecsize).astype(np.uint8)
    if width is not None and height is not None:
        if width * height != vecsize:
            raise VecError(f"{path}: vecSize {vecsize} != {width}x{height}")
        return out.reshape(count, height, width)
    return out


def write_vec(path: str, samples: np.ndarray):
    """samples: (count, h, w) uint8 → .vec (the layout of the reference's
    icvWriteVecHeader/icvWriteVecSample)."""
    samples = np.asarray(samples)
    count = samples.shape[0]
    vecsize = int(np.prod(samples.shape[1:]))
    with open(path, "wb") as f:
        hdr = np.zeros(1, _HEADER)
        hdr["count"] = count
        hdr["vecsize"] = vecsize
        f.write(hdr.tobytes())
        flat = samples.reshape(count, vecsize).astype("<i2")
        rec = np.zeros((count, 1 + 2 * vecsize), np.uint8)
        rec[:, 1:] = flat.view(np.uint8)
        f.write(rec.tobytes())


class PosReader:
    """Sequential positive-sample cursor: take() past the end raises
    (imagestorage.cpp:161-174), restart() rewinds (imagestorage.cpp:184-189)."""

    def __init__(self, path: str, win_w: int, win_h: int):
        self.samples = read_vec(path, win_w, win_h)
        self.count = self.samples.shape[0]
        self._pos = 0

    def get(self) -> np.ndarray:
        if self._pos >= self.count:
            raise VecError(
                "Can not get new positive sample. The most possible reason is "
                "insufficient count of samples in given vec-file."
            )
        s = self.samples[self._pos]
        self._pos += 1
        return s

    def take(self, n: int) -> np.ndarray:
        """Up to n samples (raises if none are left and n > 0)."""
        if n <= 0:
            return self.samples[:0]
        if self._pos >= self.count:
            raise VecError("vec-file is over")
        end = min(self._pos + n, self.count)
        out = self.samples[self._pos : end]
        self._pos = end
        return out

    @property
    def remaining(self):
        return self.count - self._pos

    def unread(self, k: int):
        """Rewind the cursor by k samples (undo part of a take())."""
        if not 0 <= k <= self._pos:
            raise ValueError(f"cannot unread {k} of {self._pos} consumed")
        self._pos -= k

    def restart(self):
        self._pos = 0
