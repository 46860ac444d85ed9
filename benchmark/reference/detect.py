"""Plain PyTorch detectMultiScale: the benchmark's reference for detection.

Written from OpenCV 4.x's runtime (cascadedetect.cpp, the Haar
evaluator) with no code of the program under test: per pyramid level,
an INTER_LINEAR_EXACT resize, integer integrals, the variance gate,
stage 0 at every grid window, the serial x-walk that skips the window
after one that stage 0 rejects, then the later stages on the survivors,
with early exit. Raw rects are grouped by ``reference/group.py``.

  - scales: factor 1, sf, sf², … while cvRound(win·factor) fits the
    image; each level cvRound(W / f32(factor)) wide, in float32
  - ystep 1 where factor ≥ 2, else 2, in x and y; y stops at the last
    stripe bound (nstripes = ceil(working width of level 0 / 32))
  - gate: nf = area·Σx² − (Σx)² over the window less a 1-pixel border;
    inv = f32(1/√nf); pass iff nf > 0 and area·inv < 0.1
  - value = f32(w0·s0 + w1·s1 + w2·s2) · inv in f32; left iff value < thr
  - stage: Σ leaves in ``acc`` (f64 by default) ≥ f32(stage thr − 1e-5)

``acc=torch.float32`` (f32 stage sums) and ``val=torch.bfloat16`` (bf16
feature values) give the lower-precision controls.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.cascade import Cascade, exact_f64_sums

THRESHOLD_EPS = np.float32(1e-5)
# windows a gather chunk holds, times the trees of a stage
_CHUNK = 1 << 23


def cv_round(v) -> int:
    return int(np.rint(np.float64(v)))


def scales(img_w: int, img_h: int, win_w: int, win_h: int, sf: float) -> list:
    out, factor = [], 1.0
    while True:
        bw, bh = cv_round(win_w * factor), cv_round(win_h * factor)
        if bw > img_w or bh > img_h:
            return out
        out.append(np.float32(factor))
        factor *= sf


def axis_table(src: int, dst: int):
    """INTER_LINEAR_EXACT source index and 8-bit coefficient per output
    coordinate, in integers: fx = ((2d+1)·src − dst) / (2·dst), the
    coefficient round-half-even(frac(fx)·256)."""
    d = np.arange(dst, dtype=np.int64)
    num = (2 * d + 1) * src - dst
    den = 2 * dst
    sx = np.floor_divide(num, den)
    rem = num - sx * den  # frac = rem / den
    a = rem * 256
    q, r = np.divmod(a, den)
    coef = q + ((2 * r > den) | ((2 * r == den) & (q % 2 == 1)))
    low = sx < 0
    sx, coef = np.where(low, 0, sx), np.where(low, 0, coef)
    high = sx >= src - 1
    sx = np.where(high, max(src - 2, 0), sx)
    coef = np.where(high, 256 if src > 1 else 0, coef)
    return sx, np.minimum(sx + 1, src - 1), coef


def resize_exact(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """(..., H, W) integer tensor → (..., dst_h, dst_w) int64, bit for bit
    cv::resize(INTER_LINEAR_EXACT) of uint8 pixels."""
    h, w = img.shape[-2:]
    dev = img.device
    y0, y1, cy = (torch.as_tensor(a, device=dev) for a in axis_table(h, dst_h))
    x0, x1, cx = (torch.as_tensor(a, device=dev) for a in axis_table(w, dst_w))
    p = img.to(torch.int64)
    rows = (256 - cy)[:, None] * p[..., y0, :] + cy[:, None] * p[..., y1, :]
    v = (256 - cx) * rows[..., x0] + cx * rows[..., x1]
    return torch.clamp_max((v + (1 << 15)) >> 16, 255)


def integral(px: torch.Tensor) -> torch.Tensor:
    """(..., h, w) → (..., h+1, w+1) int64 with a zero first row and column."""
    h, w = px.shape[-2:]
    out = torch.zeros(px.shape[:-2] + (h + 1, w + 1), dtype=torch.int64, device=px.device)
    out[..., 1:, 1:] = px.cumsum(-2).cumsum(-1)
    return out


class Counts:
    """What the reference did, for the benchmark's operation and byte
    counts: each level's size and grid windows, and per stage the
    windows that evaluated it."""

    def __init__(self, n_stages: int):
        self.levels = []  # (h, w, grid windows) per level
        self.stage_windows = np.zeros(n_stages, np.int64)


class ReferenceDetector:
    """detectMultiScale's raw windows for one cascade, on one device."""

    def __init__(self, cascade: Cascade, device="cpu", acc=torch.float64, val=torch.float32):
        self.c = cascade
        self.device = torch.device(device)
        self.acc, self.val = acc, val
        if acc == torch.float64 and not exact_f64_sums(cascade):
            raise ValueError("a stage's f64 leaf sum depends on its order; the reference "
                             "sums without a fixed order")
        dev = self.device
        self.stages = []
        for s in cascade.stages:
            r = cascade.rects[s.feature]  # (T, 3, 4)
            self.stages.append(dict(
                rects=torch.as_tensor(r, device=dev),
                w=torch.as_tensor(cascade.weights[s.feature], device=dev),
                split=torch.as_tensor(s.split, device=dev),
                left=torch.as_tensor(s.left, device=dev).to(acc),
                right=torch.as_tensor(s.right, device=dev).to(acc),
                thr=float(np.float32(s.threshold) - THRESHOLD_EPS),
            ))

    def _corner_offsets(self, st, stride):
        """(T, 3, 4) flat offsets of each rect's corners from a window's
        top-left in an integral of row stride ``stride``:
        (y, x), (y, x+w), (y+h, x), (y+h, x+w)."""
        r = st["rects"]
        x, y, w, h = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        return torch.stack([y * stride + x, y * stride + x + w,
                            (y + h) * stride + x, (y + h) * stride + x + w], dim=-1)

    def _stage_pass(self, ii_flat, base, inv, st, stride):
        """Pass mask (bool) of windows at flat offsets ``base`` with their
        f32 inverse norms ``inv``."""
        off = self._corner_offsets(st, stride).reshape(-1)  # (T·12,)
        t = st["w"].shape[0]
        out = torch.empty(base.shape[0], dtype=torch.bool, device=base.device)
        step = max(1, _CHUNK // max(1, t * 12))
        for a in range(0, base.shape[0], step):
            b = base[a : a + step]
            g = ii_flat[b[:, None] + off[None, :]].reshape(-1, t, 3, 4)
            s = (g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]).to(self.val)
            wt = st["w"][None].to(self.val)
            v = wt[..., 0] * s[..., 0] + wt[..., 1] * s[..., 1]
            v = v + wt[..., 2] * s[..., 2]
            v = v * inv[a : a + step, None].to(self.val)
            leaf = torch.where(v < st["split"][None].to(self.val), st["left"][None],
                               st["right"][None])
            out[a : a + step] = leaf.sum(1) >= st["thr"]
        return out

    def raw_batch(self, frames, sf: float = 1.1, counts: Counts | None = None) -> list:
        """(N, 4) int32 raw rects (x, y, w, h), sorted, of each uint8 frame;
        the frames, all of one size, are evaluated together level by level."""
        c = self.c
        h, w = frames[0].shape
        img = torch.as_tensor(np.stack(frames), device=self.device)
        nb = img.shape[0]
        levels = scales(w, h, c.win_w, c.win_h, sf)
        f32_w, f32_h = np.float32(w), np.float32(h)
        sizes = [(cv_round(f32_w / f), cv_round(f32_h / f)) for f in levels]
        nstripes = max(int(np.ceil((sizes[0][0] + 1 - c.win_w) / 32.0)), 1)
        out = [[] for _ in range(nb)]
        for f, (sw, sh) in zip(levels, sizes):
            if sw < c.win_w or sh < c.win_h:
                continue
            step = 1 if f >= 2 else 2
            px = resize_exact(img, sw, sh)
            ii, sq = integral(px), integral(px * px)
            del px
            stride = sw + 1
            pr_h = sh + 1 - c.win_h
            stripe = max(-(-(pr_h // step) // nstripes), 1) * step
            ys = torch.arange(0, min(nstripes * stripe, pr_h), step, device=self.device)
            xs = torch.arange(0, sw + 1 - c.win_w, step, device=self.device)
            per = len(ys) * len(xs)
            frame_base = torch.arange(nb, device=self.device) * (sh + 1) * stride
            base = (frame_base[:, None] + (ys[:, None] * stride + xs[None, :]).reshape(1, -1))
            base = base.reshape(-1)
            # variance gate on the window less a one-pixel border
            nw, nh = c.win_w - 2, c.win_h - 2
            n0 = base + stride + 1
            ends = (n0, n0 + nw, n0 + nh * stride, n0 + nh * stride + nw)
            iif, sqf = ii.reshape(-1), sq.reshape(-1)
            vs = iif[ends[0]] - iif[ends[1]] - iif[ends[2]] + iif[ends[3]]
            vq = sqf[ends[0]] - sqf[ends[1]] - sqf[ends[2]] + sqf[ends[3]]
            del sq, sqf, ends, n0
            area = float(nw * nh)
            nf = area * vq.to(torch.float64) - vs.to(torch.float64) ** 2
            pos = nf > 0
            inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, nf, 1.0)), 1.0)
            inv = inv.to(torch.float32)
            gate = pos & (area * inv.to(torch.float64) < 0.1)
            pass0 = self._stage_pass(iif, base, inv, self.stages[0], stride)
            # the x-walk: after a window the gate lets through and stage 0
            # rejects, the next window is skipped, so a window is visited
            # iff an even number of grid windows lie between it and the
            # last one before it that triggers no skip
            trig = (gate & ~pass0).reshape(nb * len(ys), len(xs))
            k = torch.arange(1, len(xs) + 1, device=self.device)[None, :]
            last = torch.cummax(torch.where(trig, torch.zeros_like(k), k), dim=1).values
            last = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
            visited = ((k - last - 1) % 2 == 0).reshape(-1)
            alive = torch.nonzero(visited & gate & pass0).reshape(-1)
            if counts is not None:
                counts.levels += [(sh, sw, per)] * nb
                counts.stage_windows[0] += int((visited & gate).sum())
            for si in range(1, len(self.stages)):
                if alive.numel() == 0:
                    break
                if counts is not None:
                    counts.stage_windows[si] += alive.numel()
                ok = self._stage_pass(iif, base[alive], inv[alive], self.stages[si], stride)
                alive = alive[ok]
            if alive.numel():
                sel = alive.cpu().numpy()
                fr, sel = sel // per, sel % per
                y = sel // len(xs) * step
                x = sel % len(xs) * step
                rx = np.rint(x.astype(np.float32) * f).astype(np.int64)
                ry = np.rint(y.astype(np.float32) * f).astype(np.int64)
                bw = cv_round(np.float32(c.win_w) * f)
                bh = cv_round(np.float32(c.win_h) * f)
                r = np.stack([rx, ry, np.full_like(rx, bw), np.full_like(rx, bh)], 1)
                for b in range(nb):
                    out[b].append(r[fr == b])
        return [sort_rects(np.concatenate(o)) if o else np.zeros((0, 4), np.int32) for o in out]


def sort_rects(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.int32).reshape(-1, 4)
    return r[np.lexsort((r[:, 3], r[:, 2], r[:, 1], r[:, 0]))]


def clip_rects(r: np.ndarray, img_w: int, img_h: int) -> np.ndarray:
    """OpenCV's clipObjects, after grouping: intersect with the image and
    drop what is left empty."""
    r = np.asarray(r, np.int64).reshape(-1, 4)
    x, y = np.maximum(r[:, 0], 0), np.maximum(r[:, 1], 0)
    w = np.minimum(r[:, 0] + r[:, 2], img_w) - x
    h = np.minimum(r[:, 1] + r[:, 3], img_h) - y
    keep = (w > 0) & (h > 0)
    return np.stack([x, y, w, h], 1)[keep].astype(np.int32)
