"""INTER_LINEAR_EXACT coefficient tables (numpy only).

A copy of ``cascadeclassifier_tpu.ops.resize._axis_tab``. OpenCV's runtime
detector builds its pyramid with ``resize(..., INTER_LINEAR_EXACT)``:

  - source position: exact rational fx = (d + 0.5)·ssz/dsz − 0.5
  - border clamp: sx < 0 → (0, frac 0); sx ≥ ssz−1 → (ssz−2, frac 1)
  - 8-fractional-bit coefficients, round-half-even
  - separable passes in integers, final (v + 2^15) >> 16 saturated

The per-pixel apply lives in ``detect/detector.py::build_pixel_canvas``.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np


@functools.lru_cache(maxsize=4096)
def _axis_tab(ssz: int, dsz: int):
    """(src_idx, coef1) int32 arrays for one axis."""
    sx_l = np.empty(dsz, np.int32)
    c_l = np.empty(dsz, np.int32)
    for d in range(dsz):
        fx = Fraction((2 * d + 1) * ssz - dsz, 2 * dsz)
        sx = fx.numerator // fx.denominator  # floor
        frac = fx - sx
        if sx < 0:
            sx, frac = 0, Fraction(0)
        if sx >= ssz - 1:
            sx, frac = (ssz - 2, Fraction(1)) if ssz > 1 else (0, Fraction(0))
        sx_l[d] = sx
        c_l[d] = round(frac * 256)  # Fraction round() = half-even, like OpenCV
    return sx_l, c_l
