"""Batched integral images of sample windows (plain PyTorch).

Counterparts of ``cascadeclassifier_tpu/ops/integral.py``
(``integral_image``, ``integral_sq``, ``integral_tilted``,
``window_norm_factor``), the integrals the training evaluator and the
mining predictor take of (N, h, w) sample windows. Integer sums are
exact in any order; the detector's canvas integral is the CUDA kernel
of ``detect/integral.py``.

Conventions (OpenCV's ``cv::integral``):
  - ``sum[..., y, x] = Σ_{i<y, j<x} img[..., i, j]``, first row and column 0
  - ``tilted[..., Y, X] = Σ over pixels (y, x) with |X − x − 1| ≤ Y − y − 1``
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def integral_image(img, dtype=torch.int32):
    """(..., H, W) → (..., H+1, W+1) of dtype, zero top row and left column."""
    x = img.to(dtype)
    s = torch.cumsum(torch.cumsum(x, dim=-1, dtype=dtype), dim=-2, dtype=dtype)
    return F.pad(s, (1, 0, 1, 0))


def integral_sq(img, dtype=torch.int64):
    """Integral image of squared pixel values (int64 by default; int32 is
    exact for windows of up to 2^31 / 255² ≈ 33k pixels)."""
    x = img.to(dtype)
    return integral_image(x * x, dtype=dtype)


def integral_tilted(img):
    """(N, H, W) → (N, H+1, W+1) int32 45°-rotated integral, by the row
    recurrence T[Y, X] = T[Y-1, X-1] + T[Y-1, X+1] − T[Y-2, X]
    + img[Y-1, X-1] + img[Y-2, X-1] on a canvas padded with H+1 zero
    columns each side (boundary effects move inward a column per row),
    cropped to the window."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    n, h, w = img.shape
    p = h + 1
    x = F.pad(img.to(torch.int32), (p, p))  # (n, h, w + 2p)
    wp = w + 2 * p
    rows = F.pad(x, (1, 0))[:, :, : wp + 1]  # img[Y-1, X-1] per row Y-1
    zero = torch.zeros((n, wp + 1), dtype=torch.int32, device=img.device)
    t_m1 = t_m2 = zero
    prev = zero
    out = [zero]
    for y in range(h):
        r1 = rows[:, y]
        left = F.pad(t_m1[:, :-1], (1, 0))
        right = F.pad(t_m1[:, 1:], (0, 1))
        t = left + right - t_m2 + r1 + prev
        out.append(t)
        t_m2, t_m1, prev = t_m1, t, r1
    t = torch.stack(out, dim=1)[:, :, p : p + w + 1]
    return t[0] if squeeze else t


def window_norm_factor(sum_img, sq_img):
    """Per-window sqrt(area·sqSum − sum²) over the window interior (the
    rect x=1, y=1, w=W−2, h=H−2 of calcNormFactor, features.cpp:13-25):
    exact int64, then an f64 sqrt, then f32. sum_img, sq_img:
    (..., H+1, W+1) → (...,) float32."""
    h1, w1 = sum_img.shape[-2], sum_img.shape[-1]
    rh, rw = h1 - 3, w1 - 3
    area = rh * rw

    def rect4(a):
        a = a.to(torch.int64)
        return a[..., 1, 1] - a[..., 1, 1 + rw] - a[..., 1 + rh, 1] + a[..., 1 + rh, 1 + rw]

    v_sum = rect4(sum_img)
    val = area * rect4(sq_img) - v_sum * v_sum
    return torch.sqrt(torch.clamp(val, min=0).to(torch.float64)).to(torch.float32)
