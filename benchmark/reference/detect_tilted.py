"""Plain PyTorch detectMultiScale for Haar stump cascades with upright and
45° tilted features: the benchmark's reference for the upper-body cell.

Written from OpenCV 4.x's runtime (cascadedetect.cpp and .hpp, the Haar
evaluator; imgproc's ``cv::integral``) with no code of the program under
test. Everything but the tilted features is ``reference/detect.py``'s
``raw_batch``, step for step: the levels, the steps, the stripes, the
variance gate on the window less a one-pixel border, stage 0 at every
grid window, the serial x-walk, the later stages on the survivors with
early exit, f32 feature values, ``acc`` stage sums (f64 by default) and
``Counts``. The tilted parts:

  - the reader takes a feature's ``<tilted>1</tilted>`` (Haar mode ALL)
    and keeps a per-feature ``tilted`` flag beside ``rects`` and
    ``weights``; it reads stump trees only
  - each level's tilted integral (``tilted_integral``), beside its sum and
    squared-sum integrals
  - a tilted rect (x, y, w, h) of a window at (wx, wy) sums
    T[p0] − T[p1] − T[p2] + T[p3] at the four corners of
    CV_TILTED_OFFSETS: p0 = (x, y), p1 = (x − h, y + h), p2 = (x + w,
    y + w), p3 = (x + w − h, y + w + h), each (column, row) from (wx, wy)

Departures from OpenCV: integrals are int64 where OpenCV keeps int32 that
wrap (a corner difference, the rect sum, is the same exact integer);
stage sums are reduced in any order, which equals OpenCV's tree-order
f64 sum only where ``exact_f64_sums`` holds (checked; it holds for
``haarcascade_upperbody.xml``); the frames of a batch are evaluated
together, level by level.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch

from benchmark.reference import detect
from benchmark.reference.cascade import Cascade, Stage, _child, _nums
from benchmark.reference.detect import Counts, cv_round, integral, resize_exact, scales, sort_rects

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class TiltedCascade(Cascade):
    tilted: np.ndarray = None  # (F,) bool: the feature's rects are 45° ones


def read_cascade(path: str) -> TiltedCascade:
    """Parse a modern-format Haar cascade of stump trees whose features
    may be tilted (OpenCV's shipped files and the trainer's cascade.xml)."""
    node = list(ET.parse(path).getroot())[0]
    if node.get("type_id") == "opencv-haar-classifier":
        raise ValueError("the legacy Haar format is not read here")
    if _child(node, "featureType").text.strip() != "HAAR":
        raise ValueError("only Haar cascades are read here")
    stages = []
    for s in _child(node, "stages").findall("_"):
        feat, split, left, right = [], [], [], []
        for t in _child(s, "weakClassifiers").findall("_"):
            nodes = _nums(_child(t, "internalNodes").text)
            leaves = _nums(_child(t, "leafValues").text)
            if len(nodes) != 4 or len(leaves) != 2 or nodes[:2] != ["0", "-1"]:
                raise ValueError("only stump trees are read here")
            feat.append(int(nodes[2]))
            split.append(float(nodes[3]))
            left.append(float(leaves[0]))
            right.append(float(leaves[1]))
        stages.append(Stage(
            threshold=float(_child(s, "stageThreshold").text),
            feature=np.asarray(feat, np.int64), split=np.asarray(split, np.float32),
            left=np.asarray(left, np.float32), right=np.asarray(right, np.float32)))
    feats = _child(node, "features").findall("_")
    rects = np.zeros((len(feats), 3, 4), np.int64)
    weights = np.zeros((len(feats), 3), np.float32)
    tilted = np.zeros(len(feats), bool)
    for i, f in enumerate(feats):
        t = f.find("tilted")
        tilted[i] = t is not None and int(t.text) != 0
        for j, r in enumerate(_child(f, "rects").findall("_")):
            v = _nums(r.text)
            rects[i, j] = [int(v[0]), int(v[1]), int(v[2]), int(v[3])]
            weights[i, j] = np.float32(float(v[4]))
    return TiltedCascade(win_w=int(_child(node, "width").text),
                         win_h=int(_child(node, "height").text), stages=stages, rects=rects,
                         weights=weights, tilted=tilted)


def tilted_integral(px: torch.Tensor) -> torch.Tensor:
    """(h, w) pixels → (h+1, w+1) int64, cv::integral's tilted output:

        T(X, Y) = Σ px(x, y) over y < Y and |x − X + 1| ≤ Y − y − 1

    (OpenCV's documentation of ``cv::integral``). The two bounds are
    x − y ≥ X − Y and x + y ≤ X + Y − 2, and they imply y < Y, so in the
    coordinates u = x + y, v = x − y the sum is a two-sided prefix sum:
    with P the pixels placed at (y + 1, x + 1) of an (h+1, w+1) array of
    zeros and G[u, v] = P at (row, column) = ((u − v)/2, (u + v)/2),

        T(X, Y) = Σ G[u, v] over u ≤ X + Y, v ≥ X − Y,

    a cumulative sum along u, then one from the top of v down."""
    h, w = px.shape
    n = h + w + 1  # u in [0, h + w], v + h in [0, h + w]
    y = torch.arange(1, h + 1, device=px.device)[:, None]
    x = torch.arange(1, w + 1, device=px.device)[None, :]
    g = torch.zeros(n * n, dtype=torch.int64, device=px.device)
    g[((y + x) * n + (x - y + h)).reshape(-1)] = px.reshape(-1).to(torch.int64)
    g = g.reshape(n, n).cumsum(0).flip(1).cumsum(1).flip(1)
    yy = torch.arange(h + 1, device=px.device)[:, None]
    xx = torch.arange(w + 1, device=px.device)[None, :]
    return g[yy + xx, xx - yy + h]


class ReferenceDetector(detect.ReferenceDetector):
    """detectMultiScale's raw windows for one stump Haar cascade with
    upright and tilted features, on one device. acc: the stage sums'
    type; val: the feature values' (the lower-precision controls).
    ``reference/detect.py``'s detector, with each stage's tilted flags and
    its rects' corners read from the tilted integral where they are set."""

    def __init__(self, cascade: TiltedCascade, device="cpu", acc=torch.float64,
                 val=torch.float32):
        super().__init__(cascade, device, acc, val)
        for st, s in zip(self.stages, cascade.stages):
            st["tilted"] = torch.as_tensor(cascade.tilted[s.feature], device=self.device)
        self._plane = 0  # the tilted integrals' offset in raw_batch's buffer

    def _corner_offsets(self, st, stride):
        """(T, 3, 4) flat offsets of each rect's corners from a window's
        top-left: upright (y, x), (y, x+w), (y+h, x), (y+h, x+w) in the sum
        integral; tilted CV_TILTED_OFFSETS (y, x), (y+h, x−h), (y+w, x+w),
        (y+w+h, x+w−h) in the tilted one, ``self._plane`` further on. Either
        sum is g0 − g1 − g2 + g3."""
        r = st["rects"]
        x, y, w, h = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        tl = torch.stack([y * stride + x, (y + h) * stride + x - h,
                          (y + w) * stride + x + w, (y + w + h) * stride + x + w - h], dim=-1)
        return torch.where(st["tilted"][:, None, None], tl + self._plane,
                           super()._corner_offsets(st, stride))

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
            # the sum integrals, then the tilted ones, in one buffer
            self._plane = nb * (sh + 1) * (sw + 1)
            ii = torch.empty((2, nb, sh + 1, sw + 1), dtype=torch.int64, device=self.device)
            ii[0] = integral(px)
            for b in range(nb):
                ii[1, b] = tilted_integral(px[b])
            sq = integral(px * px)
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
