"""Positive-sample synthesis and vec utilities (createsamples equivalent).

A copy of ``cascadeclassifier_tpu.tools.createsamples`` on the port's
host library (``data/native.py``: the .vec codec and the background
miner, byte for byte ``data/vec.py``'s and ``data/negreader.py``'s) and
``ops/resize.py``; cv2 is imported where a mode needs it.

Re-implements the reference tool's four modes
(tools/createsamples/createsamples.cpp:184-218):

  1. -img -vec          : synthesize N distorted positives over backgrounds
  2. -img -bg -info     : write distorted test images + annotations
  3. -info -vec         : crop annotated rects → vec
  4. -vec (show)        : dump vec samples as images

The distortion chain replicates utility.cpp bit-for-bit where determinism
matters: cv::RNG (multiply-with-carry) draws in the reference order,
icvRandomQuad's Rodrigues + perspective divide (utility.cpp:419-466), the
custom scanline cvWarpPerspective (utility.cpp:226-417), background
transparency mask with erode/dilate border extension (utility.cpp:516-578),
and INTER_LINEAR_EXACT resizes (ops/resize.py).
"""

from __future__ import annotations

import numpy as np

from cascadeclassifier_tpu_torch.data.native import (
    NativeNegReader,
    native_read_vec,
    native_write_vec,
)
from cascadeclassifier_tpu_torch.data.vec import VecError
from cascadeclassifier_tpu_torch.ops.resize import resize_linear_exact_np

CV_RNG_COEFF = 4164903690


class CvRNG:
    """Bit-exact replica of cv::RNG (MWC generator)."""

    def __init__(self, seed=12345):
        self.state = seed & 0xFFFFFFFFFFFFFFFF
        if self.state == 0:
            self.state = 2**32 - 1

    def next(self) -> int:
        self.state = (
            (self.state & 0xFFFFFFFF) * CV_RNG_COEFF + (self.state >> 32)
        ) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform_int(self, a: int, b: int) -> int:
        if a == b:
            return a
        v = self.next() % (b - a) + a  # C semantics: unsigned mod, int add
        return int(np.int64(v).astype(np.int32))

    def to_double(self) -> float:
        t = self.next()
        u = self.next()
        return ((t << 32) | u) * 5.421010862427522e-20

    def uniform_double(self, a: float, b: float) -> float:
        return self.to_double() * (b - a) + a

    def uniform_float(self, a: float, b: float) -> float:
        """cv::RNG::uniform(float, float): a single next() draw."""
        return float(
            np.float32(self.next() * np.float32(2.3283064365386963e-10))
            * np.float32(b - a)
            + np.float32(a)
        )


def _cv_round(v):
    return int(np.rint(np.float64(v)))


def _rodrigues(rvec):
    """Rodrigues rotation vector → matrix (cv::Rodrigues, double)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-30:
        return np.eye(3)
    r = np.asarray(rvec, np.float64) / theta
    ct, st = np.cos(theta), np.sin(theta)
    rrt = np.outer(r, r)
    rx = np.array(
        [[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]], np.float64
    )
    return ct * np.eye(3) + (1 - ct) * rrt + st * rx


def random_quad(width, height, maxxangle, maxyangle, maxzangle, rng: CvRNG):
    """icvRandomQuad (utility.cpp:419-466)."""
    distfactor, distfactor2 = 3.0, 1.0
    rx = rng.uniform_double(-maxxangle, maxxangle)
    ry = (maxyangle - abs(rx)) * rng.uniform_double(-1.0, 1.0)
    rz = rng.uniform_double(-maxzangle, maxzangle)
    d = (distfactor + distfactor2 * rng.uniform_double(-1.0, 1.0)) * width
    rot = _rodrigues([rx, ry, rz])
    halfw, halfh = 0.5 * width, 0.5 * height
    quad = np.array(
        [[-halfw, -halfh], [halfw, -halfh], [halfw, halfh], [-halfw, halfh]],
        np.float64,
    )
    out = np.empty((4, 2), np.float64)
    for i in range(4):
        v = rot @ np.array([quad[i, 0], quad[i, 1], 0.0])
        out[i, 0] = v[0] * d / (d + v[2]) + halfw
        out[i, 1] = v[1] * d / (d + v[2]) + halfh
    return out


def _perspective_coeffs(src_w, src_h, quad):
    """cvGetPerspectiveTransform (utility.cpp:180-223): maps quad →
    ((0,0),(u,0),(u,v),(0,v)) with u=src_w−1, v=src_h−1."""
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    u, v = src_w - 1, src_h - 1
    for i in range(4):
        a[i, 0], a[i, 1], a[i, 2] = quad[i, 0], quad[i, 1], 1.0
        a[i + 4, 3], a[i + 4, 4], a[i + 4, 5] = quad[i, 0], quad[i, 1], 1.0
    a[1, 6], a[1, 7] = -quad[1, 0] * u, -quad[1, 1] * u
    a[2, 6], a[2, 7] = -quad[2, 0] * u, -quad[2, 1] * u
    b[1] = b[2] = u
    a[6, 6], a[6, 7] = -quad[2, 0] * v, -quad[2, 1] * v
    a[7, 6], a[7, 7] = -quad[3, 0] * v, -quad[3, 1] * v
    b[6] = b[7] = v
    x = np.linalg.solve(a, b)
    c = np.empty((3, 3), np.float64)
    c.flat[:8] = x
    c[2, 2] = 1.0
    return c


def warp_perspective(src: np.ndarray, dst: np.ndarray, quad: np.ndarray):
    """The reference's scanline warp (utility.cpp:226-417), writing into
    dst in place (pixels outside the quad keep their values)."""
    c = _perspective_coeffs(src.shape[1], src.shape[0], quad)

    # orientation
    direction = 0
    for i in range(4):
        ni, pi = (i + 1) % 4, (i - 1) % 4
        d = (quad[i, 0] - quad[pi, 0]) * (quad[ni, 1] - quad[i, 1]) - (
            quad[i, 1] - quad[pi, 1]
        ) * (quad[ni, 0] - quad[i, 0])
        cur = 1 if d > 0 else (-1 if d < 0 else 0)
        if direction == 0:
            direction = cur
        elif direction * cur < 0:
            raise ValueError("Quadrangle is nonconvex or degenerated.")
    if direction == 0:
        raise ValueError("Quadrangle is nonconvex or degenerated.")

    left = 0
    for i in range(1, 4):
        if (quad[i, 1] < quad[left, 1]) or (
            quad[i, 1] == quad[left, 1] and quad[i, 0] < quad[left, 0]
        ):
            left = i
    q = np.empty((4, 2), np.float64)
    if direction > 0:
        for i in range(left, 4):
            q[i - left] = quad[i]
        for i in range(left):
            q[4 - left + i] = quad[i]
    else:
        for i in range(left, -1, -1):
            q[left - i] = quad[i]
        for i in range(3, left, -1):
            q[4 + left - i] = quad[i]

    left = right = 0
    if q[0, 1] == q[1, 1]:
        right = 1
    next_left, next_right = 3, right + 1
    y_min = q[left, 1] - 1

    def edge(i, j):
        k = (q[i, 0] - q[j, 0]) / (q[i, 1] - q[j, 1])
        b = (q[i, 1] * q[j, 0] - q[i, 0] * q[j, 1]) / (q[i, 1] - q[j, 1])
        return k, b

    k_left, b_left = edge(left, next_left)
    k_right, b_right = edge(right, next_right)
    sh, sw = src.shape
    dh, dw = dst.shape
    srcf = src.astype(np.float64)

    while True:
        y_max = min(q[next_left, 1], q[next_right, 1])
        iy_min = max(_cv_round(y_min), 0) + 1
        iy_max = min(_cv_round(y_max), dh - 1)
        x_min = k_left * iy_min + b_left
        x_max = k_right * iy_min + b_right

        for y in range(iy_min, iy_max + 1):
            ix_min = max(_cv_round(x_min), 0)
            ix_max = min(_cv_round(x_max), dw - 1)
            if ix_max >= ix_min:
                xs = np.arange(ix_min, ix_max + 1, dtype=np.float64)
                div = c[2, 0] * xs + c[2, 1] * y + c[2, 2]
                sx = (c[0, 0] * xs + c[0, 1] * y + c[0, 2]) / div
                sy = (c[1, 0] * xs + c[1, 1] * y + c[1, 2]) / div
                isx = np.floor(sx).astype(np.int64)
                isy = np.floor(sy).astype(np.int64)
                dx = sx - isx
                dy = sy - isy

                def pick(ix, iy, okx, oky):
                    ok = okx & oky
                    v = np.zeros(len(xs), np.float64)
                    v[ok] = srcf[iy[ok], ix[ok]]
                    return v

                i00 = pick(isx, isy, (isx >= 0) & (isx < sw), (isy >= 0) & (isy < sh))
                i10 = pick(
                    isx + 1, isy, (isx >= -1) & (isx + 1 < sw), (isy >= 0) & (isy < sh)
                )
                i01 = pick(
                    isx, isy + 1, (isx >= 0) & (isx < sw), (isy >= -1) & (isy + 1 < sh)
                )
                i11 = pick(
                    isx + 1,
                    isy + 1,
                    (isx >= -1) & (isx + 1 < sw),
                    (isy >= -1) & (isy + 1 < sh),
                )
                i0 = i00 + (i10 - i00) * dx
                i1 = i01 + (i11 - i01) * dx
                dst[y, ix_min : ix_max + 1] = (i0 + (i1 - i0) * dy).astype(
                    np.uint8
                )
            x_min += k_left
            x_max += k_right

        if (next_left == next_right) or (
            next_left + 1 == next_right
            and q[next_left, 1] == q[next_right, 1]
        ):
            break
        if y_max == q[next_left, 1]:
            left, next_left = next_left, next_left - 1
            k_left, b_left = edge(left, next_left)
        if y_max == q[next_right, 1]:
            right, next_right = next_right, next_right + 1
            k_right, b_right = edge(right, next_right)
        y_min = y_max


class SampleDistorter:
    """icvStartSampleDistortion + icvPlaceDistortedSample
    (utility.cpp:516-672)."""

    def __init__(self, img_path, bgcolor=0, bgthreshold=80):
        import cv2

        src = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
        if src is None:
            raise FileNotFoundError(img_path)
        self.bgcolor = bgcolor
        self.dx, self.dy = src.shape[1] // 2, src.shape[0] // 2
        mask = np.where(
            (src.astype(int) >= bgcolor - bgthreshold)
            & (src.astype(int) <= bgcolor + bgthreshold),
            0,
            255,
        ).astype(np.uint8)
        er = cv2.erode(src, None)
        di = cv2.dilate(src, None)
        src = src.copy()
        bgmask = mask == 0
        de = (np.int64(bgcolor) - er.astype(np.int64)).astype(np.uint8)
        dd = (di.astype(np.int64) - np.int64(bgcolor)).astype(np.uint8)
        use_er = bgmask & (de >= dd) & (de > bgthreshold)
        use_di = bgmask & (dd > de) & (dd > bgthreshold)
        src[use_er] = er[use_er]
        src[use_di] = di[use_di]
        self.src = src
        self.mask = mask
        h, w = src.shape
        self.imgbuf = np.empty((h + 2 * self.dy, w + 2 * self.dx), np.uint8)
        self.maskbuf = np.empty_like(self.imgbuf)

    def place(
        self,
        background: np.ndarray,
        rng: CvRNG,
        inverse=False,
        maxintensitydev=40,
        maxxangle=1.1,
        maxyangle=1.1,
        maxzangle=0.5,
        maxshiftf=0.0,
        maxscalef=0.0,
    ):
        """Distort + blend onto `background` in place."""
        import cv2

        sh, sw = self.src.shape
        quad = random_quad(sw, sh, maxxangle, maxyangle, maxzangle, rng)
        quad = quad + np.array([self.dx, self.dy], np.float64)

        self.imgbuf[:] = self.bgcolor
        self.maskbuf[:] = 0
        warp_perspective(self.src, self.imgbuf, quad)
        warp_perspective(self.mask, self.maskbuf, quad)
        maskimg = cv2.GaussianBlur(self.maskbuf, (3, 3), 0)

        cr_x, cr_y = self.dx, self.dy
        cr_w, cr_h = sw, sh

        xshift = rng.uniform_double(0.0, maxshiftf)
        yshift = rng.uniform_double(0.0, maxshiftf)
        cr_x -= int(xshift * cr_w)
        cr_y -= int(yshift * cr_h)
        cr_w = int((1.0 + maxshiftf) * cr_w)
        cr_h = int((1.0 + maxshiftf) * cr_h)

        randscale = rng.uniform_double(0.0, maxscalef)
        cr_x -= int(0.5 * randscale * cr_w)
        cr_y -= int(0.5 * randscale * cr_h)
        cr_w = int((1.0 + randscale) * cr_w)
        cr_h = int((1.0 + randscale) * cr_h)

        bh, bw = background.shape
        scale = max(
            np.float32(cr_w) / np.float32(bw), np.float32(cr_h) / np.float32(bh)
        )
        roi_x = int(np.float32(-0.5) * (scale * bw - cr_w) + cr_x)
        roi_y = int(np.float32(-0.5) * (scale * bh - cr_h) + cr_y)
        roi_w = int(scale * bw)
        roi_h = int(scale * bh)

        def crop(a):
            # roi & Rect(0,0,size) — intersection with the buffer
            x0, y0 = max(roi_x, 0), max(roi_y, 0)
            x1 = min(roi_x + roi_w, a.shape[1])
            y1 = min(roi_y + roi_h, a.shape[0])
            return a[y0:y1, x0:x1]

        img = resize_linear_exact_np(crop(self.imgbuf), bw, bh)
        alpha = resize_linear_exact_np(crop(maskimg), bw, bh).astype(np.int64)

        forecolordev = rng.uniform_int(-maxintensitydev, maxintensitydev)
        chartmp = np.clip(img.astype(np.int64) + forecolordev, 0, 255)
        if inverse:
            chartmp = chartmp ^ 0xFF
        blended = (
            chartmp * alpha + (255 - alpha) * background.astype(np.int64)
        ) // 255
        background[:] = blended.astype(np.uint8)


def create_training_samples(
    vec_path,
    img_path,
    count,
    bgcolor=0,
    bgthreshold=80,
    bg_path=None,
    invert=False,
    maxintensitydev=40,
    maxxangle=1.1,
    maxyangle=1.1,
    maxzangle=0.5,
    win_w=24,
    win_h=24,
    rngseed=12345,
):
    """-img -vec mode (cvCreateTrainingSamples, utility.cpp:952-1030)."""
    rng = CvRNG(rngseed)
    dist = SampleDistorter(img_path, bgcolor, bgthreshold)
    samples = np.full((count, win_h, win_w), bgcolor, np.uint8)
    if bg_path:
        # the reference takes one window per sample; the schedule draws
        # nothing from rng, and runs dry only on a list with no usable
        # background, so the windows can be taken in one batch
        bg_reader = NativeNegReader(bg_path, win_w, win_h)
        windows = bg_reader.take_batch(count)
        bg_reader.close()
        samples[: len(windows)] = windows
    for i in range(count):
        dist.place(
            samples[i],
            rng,
            inverse=invert,
            maxintensitydev=maxintensitydev,
            maxxangle=maxxangle,
            maxyangle=maxyangle,
            maxzangle=maxzangle,
        )
    _write_vec(vec_path, samples)
    return count


def _write_vec(path, samples):
    if not native_write_vec(path, samples):
        raise OSError(f"cannot write {path}")


def create_samples_from_info(info_path, vec_path, num, win_w, win_h):
    """-info -vec mode (cvCreateTrainingSamplesFromInfo,
    utility.cpp:1125-1232): crop annotated rects, resize (INTER_AREA when
    downscaling else INTER_LINEAR_EXACT), write vec."""
    import os

    import cv2

    base = os.path.dirname(info_path)
    out = []
    with open(info_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            fname, cnt = parts[0], int(parts[1])
            img = cv2.imread(os.path.join(base, fname), cv2.IMREAD_GRAYSCALE)
            vals = [int(v) for v in parts[2:]]
            for i in range(cnt):
                if len(out) >= num:
                    break
                x, y, w, h = vals[4 * i : 4 * i + 4]
                crop = img[y : y + h, x : x + w]
                if w >= win_w and h >= win_h:
                    s = cv2.resize(
                        crop, (win_w, win_h), interpolation=cv2.INTER_AREA
                    )
                else:
                    s = resize_linear_exact_np(crop, win_w, win_h)
                out.append(s)
            if len(out) >= num:
                break
    samples = np.stack(out) if out else np.zeros((0, win_h, win_w), np.uint8)
    _write_vec(vec_path, samples)
    return len(out)


def show_vec_samples(vec_path, out_dir, width=None, height=None, limit=64):
    """-vec viewer mode → dumps PNG files instead of a GUI."""
    import os

    import cv2

    raw = native_read_vec(vec_path)
    if raw is None:
        raise VecError(f"{vec_path}: not a readable vec file")
    os.makedirs(out_dir, exist_ok=True)
    n, vecsize = raw.shape
    if width is None or height is None:
        # guess like cvShowVecSamples: the squarest factorization
        best = (1, vecsize)
        for h in range(1, int(np.sqrt(vecsize)) + 1):
            if vecsize % h == 0:
                best = (h, vecsize // h)
        height, width = best
    imgs = raw.reshape(n, height, width)
    for i in range(min(n, limit)):
        cv2.imwrite(os.path.join(out_dir, f"sample_{i:05d}.png"), imgs[i])
    return n


def create_test_samples(
    info_path,
    img_path,
    bg_path,
    count,
    bgcolor=0,
    bgthreshold=80,
    invert=False,
    maxintensitydev=40,
    maxxangle=1.1,
    maxyangle=1.1,
    maxzangle=0.5,
    win_w=24,
    win_h=24,
    maxscale=-1.0,
    rngseed=12345,
):
    """-img -bg -info mode (cvCreateTestSamples, utility.cpp:1031-1123):
    write full background images with one distorted object placed at a
    random position/scale, plus the annotation file."""
    import os

    import cv2

    rng = CvRNG(rngseed)
    dist = SampleDistorter(img_path, bgcolor, bgthreshold)
    bgs = [
        line for line in open(bg_path).read().splitlines() if line.strip()
    ]
    base = os.path.dirname(info_path) or "."
    os.makedirs(base, exist_ok=True)
    n = min(count, len(bgs))
    written = 0
    with open(info_path, "w") as info:
        for i in range(n):
            bg = cv2.imread(bgs[i], cv2.IMREAD_GRAYSCALE)
            if bg is None:
                continue
            ms = maxscale
            if ms < 0.0:
                ms = min(
                    np.float32(0.7) * bg.shape[1] / win_w,
                    np.float32(0.7) * bg.shape[0] / win_h,
                )
            if ms < 1.0:
                continue
            scale = np.float32(rng.uniform_float(1.0, float(ms)))
            width = int(scale * win_w)
            height = int(scale * win_h)
            x = int(rng.uniform_double(0.1, 0.8) * (bg.shape[1] - width))
            y = int(rng.uniform_double(0.1, 0.8) * (bg.shape[0] - height))
            roi = bg[y : y + height, x : x + width]
            dist.place(
                roi,
                rng,
                inverse=invert,
                maxintensitydev=maxintensitydev,
                maxxangle=maxxangle,
                maxyangle=maxyangle,
                maxzangle=maxzangle,
            )
            fname = f"{i + 1:04d}_{x:04d}_{y:04d}_{width:04d}_{height:04d}.jpg"
            info.write(f"{fname} 1 {x} {y} {width} {height}\n")
            cv2.imwrite(os.path.join(base, fname), bg)
            written += 1
    return written
