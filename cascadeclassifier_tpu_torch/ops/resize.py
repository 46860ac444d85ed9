"""Bit-exact INTER_LINEAR_EXACT resize for uint8.

A copy of ``cascadeclassifier_tpu.ops.resize``: the coefficient tables
and the host resize in numpy, the mining levels in torch. OpenCV's
runtime detector and the trainer's negative miner resize with
``INTER_LINEAR_EXACT``:

  - source position: exact rational fx = (d + 0.5)·ssz/dsz − 0.5
  - border clamp: sx < 0 → (0, frac 0); sx ≥ ssz−1 → (ssz−2, frac 1)
  - 8-fractional-bit coefficients, round-half-even
  - separable passes in integers, final (v + 2^15) >> 16 saturated

The per-pixel apply of the detector lives in
``detect/detector.py::build_pixel_canvas``.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch


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


def resize_linear_exact_np(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """(..., H, W) uint8 → (..., dst_h, dst_w) uint8, bit-exact with
    cv2.resize(INTER_LINEAR_EXACT)."""
    sh, sw = img.shape[-2], img.shape[-1]
    if (sh, sw) == (dst_h, dst_w):
        return img
    sxs, cxs = _axis_tab(sw, dst_w)
    sys_, cys = _axis_tab(sh, dst_h)
    s = img.astype(np.uint32)
    h = (256 - cxs) * np.take(s, sxs, axis=-1) + cxs * np.take(
        s, np.minimum(sxs + 1, sw - 1), axis=-1
    )
    v = (256 - cys)[:, None] * np.take(h, sys_, axis=-2) + cys[:, None] * np.take(
        h, np.minimum(sys_ + 1, sh - 1), axis=-2
    )
    return np.minimum((v + (1 << 15)) >> 16, 255).astype(np.uint8)


def _axis_tab_dev(ssz: int, sbound: int, dsz: int, off: int, out_n: int, device):
    """Tensor twin of _axis_tab with an origin shift: (idx0, idx1, coef)
    int64 for output coords off..off+out_n-1 of an (ssz → dsz) axis; idx1
    clamps to sbound for sources padded wider than ssz; coords past dsz
    get index 0 and coefficient 0. Integer round-half-even, equal value
    for value to the Fraction arithmetic of _axis_tab."""
    d = torch.arange(out_n, dtype=torch.int64, device=device) + off
    two = 2 * dsz
    num = (2 * d + 1) * ssz - dsz  # = fx · 2·dsz
    sx = torch.div(num, two, rounding_mode="floor")
    rem = num - sx * two
    a = 128 * rem
    q = torch.div(a, dsz, rounding_mode="floor")
    r = a - q * dsz
    c = q + ((2 * r > dsz) | ((2 * r == dsz) & (q % 2 == 1))).to(torch.int64)
    neg = sx < 0
    sx = torch.where(neg, 0, sx)
    c = torch.where(neg, 0, c)
    hi = sx >= ssz - 1
    sx = torch.where(hi, max(ssz - 2, 0), sx)
    c = torch.where(hi, 256 if ssz > 1 else 0, c)
    oob = d >= dsz
    sx = torch.where(oob, 0, sx)
    c = torch.where(oob, 0, c)
    return sx, torch.clamp(sx + 1, max=sbound - 1), c


def build_level(src, sh: int, sw: int, dh: int, dw: int, oy: int, ox: int,
                hp: int, wp: int):
    """One origin-shifted resized mining level, on src's device.

    src: (Hs, Ws) uint8 holding a (sh, sw) source at its top left; output
    (hp, wp) uint8 = resize_linear_exact_np(src[:sh, :sw], dw, dh)[oy:oy+hp,
    ox:ox+wp], zeros past the level. Both passes stay exact integers
    (coef ≤ 256, pixel ≤ 255 ⇒ v < 2^25), so the pass order is free."""
    hs, ws = src.shape
    ry0, ry1, cy = _axis_tab_dev(sh, hs, dh, oy, hp, src.device)
    cx0, cx1, cx = _axis_tab_dev(sw, ws, dw, ox, wp, src.device)
    s = src.to(torch.int64)
    v = (256 - cy)[:, None] * s[ry0] + cy[:, None] * s[ry1]  # (hp, Ws)
    h = (256 - cx)[None, :] * v[:, cx0] + cx[None, :] * v[:, cx1]  # (hp, wp)
    out = torch.clamp((h + (1 << 15)) >> 16, max=255).to(torch.uint8)
    ri = torch.arange(hp, device=src.device)[:, None]
    ci = torch.arange(wp, device=src.device)[None, :]
    return torch.where((ri < dh - oy) & (ci < dw - ox), out, 0).to(torch.uint8)


def build_level_stack(src_stack, params, hp: int, wp: int):
    """(L, Hs, Ws) uint8 sources + (6, L) int params [sh, sw, dh, dw, oy, ox]
    → (L, hp, wp) uint8 origin-shifted resized level slots."""
    p = np.asarray(torch.as_tensor(params).cpu(), np.int64)
    src_stack = torch.as_tensor(src_stack)
    return torch.stack([
        build_level(src_stack[i], *(int(v) for v in p[:, i]), hp, wp)
        for i in range(src_stack.shape[0])
    ])
