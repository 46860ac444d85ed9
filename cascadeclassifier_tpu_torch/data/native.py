"""ctypes bindings for the port's host library (``csrc/cctpu_io.cpp``).

The library holds the exact ``cv::groupRectangles`` (an all-pairs
union-find, the quickest grouping up to ``detect/grouping.py::
NATIVE_MAX`` rects), the ``.vec`` codec and the deterministic
negative-window miner, in C++ with the standard library alone.
``_build.build_host`` compiles it with g++ at first use; a failed build
raises, and nothing falls back. ``data/vec.py``, ``data/negreader.py`` and
the numpy grouping are its plain versions, and the tests hold each pair
byte for byte. The detector groups through it (``detect/grouping.py``),
and ``tools/createsamples.py`` mines its background windows and reads and
writes its ``.vec`` files through it.

The miner keeps its schedule in C++ and asks Python for each
background's pixels (``negreader.imread_gray``, or the ``imread`` given),
so it reads every file type ``NegReader`` reads, and skips what
``NegReader`` skips.
"""

from __future__ import annotations

import ctypes

import numpy as np

from cascadeclassifier_tpu_torch.data.negreader import NegReader, imread_gray

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_INTP = ctypes.POINTER(ctypes.c_int)
# status (1 an image, 0 unreadable, 2 another layout, < 0 an error),
# path, out: data, rows, cols
IMREAD_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(_U8P), _INTP, _INTP)

_SIGNATURES = {
    "cctpu_vec_open": (ctypes.c_void_p, [ctypes.c_char_p, _INTP, _INTP]),
    "cctpu_vec_read": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _U8P]),
    "cctpu_vec_close": (None, [ctypes.c_void_p]),
    "cctpu_vec_write": (ctypes.c_int, [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int]),
    "cctpu_neg_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         IMREAD_FN]),
    "cctpu_neg_next": (ctypes.c_int, [ctypes.c_void_p, _U8P, ctypes.c_int]),
    "cctpu_neg_close": (None, [ctypes.c_void_p]),
    "cctpu_group_rectangles": (ctypes.c_int, [_I32P, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_double, _I32P]),
}

_LIB = None


def get_lib() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _LIB
    if _LIB is None:
        from cascadeclassifier_tpu_torch import _build

        # RTLD_LOCAL: the library's symbols stay its own. It links nothing
        # but the C++ runtime, so unlike a library built against a system
        # OpenCV it needs no RTLD_DEEPBIND to keep clear of cv2's.
        lib = ctypes.CDLL(_build.build_host(), mode=ctypes.RTLD_LOCAL)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def group_rectangles_native(rects, group_threshold: int, eps: float = 0.2) -> np.ndarray:
    """cv::groupRectangles in the host library: (N, 4) int rects →
    (M, 4) int32, as ``detect/grouping.py::group_rectangles``."""
    rin = np.ascontiguousarray(np.asarray(rects).reshape(-1, 4), np.int32)
    out = np.empty_like(rin)
    m = get_lib().cctpu_group_rectangles(rin.ctypes.data_as(_I32P), len(rin),
                                         int(group_threshold), float(eps),
                                         out.ctypes.data_as(_I32P))
    return out[:m].copy()


def native_read_vec(path: str):
    """(count, vecsize) uint8 array via the native decoder, or None when
    the file cannot be read or holds fewer records than its header says."""
    lib = get_lib()
    count = ctypes.c_int()
    vecsize = ctypes.c_int()
    h = lib.cctpu_vec_open(path.encode(), ctypes.byref(count), ctypes.byref(vecsize))
    if not h:
        return None
    out = np.empty((count.value, vecsize.value), np.uint8)
    got = lib.cctpu_vec_read(h, 0, count.value, out.ctypes.data_as(_U8P))
    lib.cctpu_vec_close(h)
    if got != count.value:
        return None
    return out


def native_write_vec(path: str, samples: np.ndarray) -> bool:
    """Write (count, ...) uint8 samples as a .vec; False when the file
    cannot be written."""
    s = np.ascontiguousarray(samples.reshape(samples.shape[0], int(np.prod(samples.shape[1:]))),
                             np.uint8)
    n = get_lib().cctpu_vec_write(path.encode(), s.ctypes.data_as(_U8P), s.shape[0],
                                  s.shape[1])
    return n == s.shape[0]


class NativeNegReader:
    """The native miner, with ``take_batch`` equal byte for byte to
    ``data/negreader.py::NegReader``'s: the same windows in the same
    order. imread: as NegReader's (path → 2-D uint8 image, or None)."""

    def __init__(self, bg_path: str, win_w: int, win_h: int, imread=None):
        self._lib = get_lib()
        self.win_w, self.win_h = win_w, win_h
        self._raw_imread = imread_gray if imread is None else imread
        self._src_cache = {}
        self._held = None  # the image handed to the library last
        self._error = None
        self._cb = IMREAD_FN(self._imread)  # kept alive as long as the handle
        self._h = self._lib.cctpu_neg_open(bg_path.encode(), win_w, win_h, self._cb)
        if not self._h:
            raise FileNotFoundError(f"no backgrounds in {bg_path}")

    def _imread(self, path, data, rows, cols) -> int:
        try:
            name = path.decode()
            img = self._src_cache.get(name)
            if img is None:
                img = self._raw_imread(name)
                if img is not None and len(self._src_cache) < NegReader.SRC_CACHE_CAP:
                    self._src_cache[name] = img
            if img is None or img.size == 0:
                return 0
            rows[0], cols[0] = int(img.shape[0]), int(img.shape[1])
            if img.ndim != 2:
                return 2
            self._held = np.ascontiguousarray(img, np.uint8)
            data[0] = self._held.ctypes.data_as(_U8P)
            return 1
        except Exception as e:  # handed to take_batch, which raises it
            self._error = e
            return -1

    def take_batch(self, n: int) -> np.ndarray:
        """Next n schedule windows as (m, win_h, win_w) uint8, m ≤ n."""
        out = np.empty((n, self.win_h, self.win_w), np.uint8)
        got = self._lib.cctpu_neg_next(self._h, out.ctypes.data_as(_U8P), n)
        if got < 0:
            err, self._error = self._error, None
            raise err
        return out[:got]

    def close(self):
        if self._h:
            self._lib.cctpu_neg_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
