"""Plain PyTorch traincascade: the benchmark's reference for training.

Written from opencv_traincascade (cascadeclassifier.cpp, boost.cpp,
imagestorage.cpp, haarfeatures.cpp) with no code of the program under
test, for what the training cells run: Haar BASIC features, GAB
stumps (-bt GAB -maxDepth 1).

  - features: traincascade's BASIC catalog in its order (x, y, dx, dy,
    then the templates x2, y2, x3, y3, x2_y2; weights −1 and +2); a
    sample's value f32(Σ w·rectsum) / f32(√(area·Σx² − (Σx)²)) over the
    window less a one-pixel border, 0 where that norm is 0
  - a stage accepts where Σ leaves (f64) ≥ its threshold − 1e-5; a stump
    goes left where value ≤ its f32 split
  - positives: from the start of the .vec each stage, the first numPos
    that the stages so far accept; negatives: the background schedule
    (images round-robin, each from a round-derived offset at the scale
    that fits the window, windows half a window apart, scale · √2 until
    it passes 1), which carries over from stage to stage, the first
    rint(numNeg · pos / numPos) windows accepted
  - GAB: weights 1/N; per tree the best regression split of the trimmed
    samples over every feature (quality Σ_L(wy)²/Σ_L w + Σ_R(wy)²/Σ_R w,
    a split only between sorted values more than 2·FLT_EPSILON apart,
    threshold the f32 midpoint), leaves the weighted mean response of
    each side; w ·= exp(−y·f), normalised, trimmed to weightTrimRate;
    the stage threshold the sum at rank int((1 − minHitRate)·numPos) of
    the sorted positive sums, stop once the false alarm is at most
    maxFalseAlarmRate or at maxWeakCount trees

``Judge`` follows a trained cascade stage by stage on the reference's
own samples and weights, taking each tree's split and leaves as the
program chose them, and reads how far each choice lies from the
reference's. ``train`` is the same arithmetic choosing its own trees,
in f64 or, for the control, f32.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch

from benchmark.reference.cascade import Cascade, Stage
from benchmark.reference.detect import integral, resize_exact

FLT_EPSILON = float(np.float32(1.1920929e-07))
CV_THRESHOLD_EPS = 1e-5
SCALE_FACTOR = np.float32(1.4142135623730950488016887242097)
STEP_FACTOR = np.float32(0.5)
_BLOCK = 8192  # features a block


# ------------------------------------------------------------------ data


def read_vec(path: str, win: int) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    n, size, _, _ = struct.unpack("<iihh", data[:12])
    if size != win * win:
        raise ValueError(f".vec samples hold {size} pixels, not {win}x{win}")
    body = np.frombuffer(data, np.uint8, offset=12).reshape(n, 1 + 2 * size)
    return body[:, 1:].copy().view("<i2").astype(np.uint8).reshape(n, win, win)


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    head = data.split(maxsplit=4)
    if head[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM")
    w, h = int(head[1]), int(head[2])
    return np.frombuffer(data[len(data) - w * h:], np.uint8).reshape(h, w).copy()


def haar_basic(win_w: int, win_h: int):
    """traincascade's BASIC catalog: (F, 3, 4) int64 rects, (F, 3) f32."""
    x, y, dx, dy = np.meshgrid(np.arange(win_w), np.arange(win_h), np.arange(1, win_w + 1),
                               np.arange(1, win_h + 1), indexing="ij")
    x, y, dx, dy = (a.reshape(-1) for a in (x, y, dx, dy))
    z = np.zeros_like(x)
    templates = [  # (valid, rects as (x, y, w, h) triples, weights)
        (x + 2 * dx <= win_w) & (y + dy <= win_h),
        (x + dx <= win_w) & (y + 2 * dy <= win_h),
        (x + 3 * dx <= win_w) & (y + dy <= win_h),
        (x + dx <= win_w) & (y + 3 * dy <= win_h),
        (x + 2 * dx <= win_w) & (y + 2 * dy <= win_h),
    ]
    rects = [
        [(x, y, 2 * dx, dy), (x + dx, y, dx, dy), (z, z, z, z)],
        [(x, y, dx, 2 * dy), (x, y + dy, dx, dy), (z, z, z, z)],
        [(x, y, 3 * dx, dy), (x + dx, y, dx, dy), (z, z, z, z)],
        [(x, y, dx, 3 * dy), (x, y + dy, dx, dy), (z, z, z, z)],
        [(x, y, 2 * dx, 2 * dy), (x, y, dx, dy), (x + dx, y + dy, dx, dy)],
    ]
    weights = [(-1, 2, 0)] * 4 + [(-1, 2, 2)]
    all_r, all_w, keys = [], [], []
    for t, (ok, rs, ws) in enumerate(zip(templates, rects, weights)):
        idx = np.nonzero(ok)[0]
        r = np.stack([np.stack([c[idx] for c in rect], 1) for rect in rs], 1)
        all_r.append(r)
        all_w.append(np.tile(np.asarray(ws, np.float32), (len(idx), 1)))
        keys.append(idx * 8 + t)
    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(all_r)[order].astype(np.int64), np.concatenate(all_w)[order]


class NegSchedule:
    """The background window schedule, a whole (image, scale) level at a
    time; its state carries over from fill to fill."""

    def __init__(self, images: list, win: int):
        self.images, self.win = images, win
        self.last = self.round = 0
        self.src = self.img_size = None
        self.point = self.offset = (0, 0)
        self.scale = np.float32(1)

    def _next_img(self):
        n, win = len(self.images), self.win
        for _ in range(n):
            src = self.images[self.last]
            self.last += 1
            self.round = (self.round + self.last // n) % (win * win)
            self.last %= n
            ox = min(self.round % win, src.shape[1] - win)
            oy = min(self.round // win, src.shape[0] - win)
            if ox >= 0 and oy >= 0:
                break
        else:
            raise RuntimeError("no background holds a window")
        self.src, self.point = src, (ox, oy)
        self.offset = (ox, oy)
        rows, cols = src.shape
        self.scale = np.float32(max(np.float32(win + ox) / np.float32(cols),
                                    np.float32(win + oy) / np.float32(rows)))
        self.img_size = (int(self.scale * cols + np.float32(0.5)),
                         int(self.scale * rows + np.float32(0.5)))

    def level(self):
        """(source, (w, h), xs, ys, first): the windows left in the level,
        row by row from ``point``; the first row starts at xs[first]."""
        if self.src is None:
            self._next_img()
        w, h = self.img_size
        step = int(STEP_FACTOR * self.win)
        reach = float(np.float32(1.0) + STEP_FACTOR) * self.win
        xs = [self.offset[0]]
        while int(xs[-1] + reach) < w:
            xs.append(xs[-1] + step)
        ys = [self.point[1]]
        while int(ys[-1] + reach) < h:
            ys.append(ys[-1] + step)
        return self.src, (w, h), np.asarray(xs), np.asarray(ys), xs.index(self.point[0])

    def advance(self, xs, ys, first, k):
        """Stand after the k-th window (0-based) of ``level()``'s run; past
        the run, on the next level."""
        nx = len(xs)
        q = first + k + 1  # grid index of the next window
        if q < nx * len(ys):
            self.point = (int(xs[q % nx]), int(ys[q // nx]))
            return
        self.point = self.offset
        self.scale = np.float32(self.scale * SCALE_FACTOR)
        if self.scale <= 1.0:
            rows, cols = self.src.shape
            self.img_size = (int(self.scale * cols), int(self.scale * rows))
        else:
            self._next_img()


# --------------------------------------------------------------- features


class Features:
    """Feature values of samples held as integrals on one device."""

    def __init__(self, win: int, device):
        self.win, self.dev = win, torch.device(device)

    def set_integrals(self, ii: torch.Tensor, sq: torch.Tensor, base: torch.Tensor, stride: int):
        """Integral images (flat, int64) and each sample's top-left offset
        in them, with the row stride."""
        self.ii, self.base, self.stride = ii.reshape(-1), base, stride
        n0 = base + stride + 1
        b = self.win - 2
        c = (n0, n0 + b, n0 + b * stride, n0 + b * stride + b)
        s = self.ii[c[0]] - self.ii[c[1]] - self.ii[c[2]] + self.ii[c[3]]
        q = sq.reshape(-1)
        q = q[c[0]] - q[c[1]] - q[c[2]] + q[c[3]]
        self.nf = torch.sqrt((b * b * q - s * s).clamp_min(0).to(torch.float64)).to(torch.float32)

    def set_samples(self, samples: np.ndarray):
        x = torch.as_tensor(samples, device=self.dev).to(torch.int64)
        n, w = x.shape[0], self.win
        ii = torch.zeros((n, w + 1, w + 1), dtype=torch.int64, device=self.dev)
        sq = torch.zeros_like(ii)
        ii[:, 1:, 1:] = x.cumsum(1).cumsum(2)
        sq[:, 1:, 1:] = (x * x).cumsum(1).cumsum(2)
        self.set_integrals(ii, sq, torch.arange(n, device=self.dev) * (w + 1) ** 2, w + 1)

    def values(self, rects, weights) -> torch.Tensor:
        """(F, N) f32 values of the features (rects (F, 3, 4), weights (F, 3))."""
        r = torch.as_tensor(rects, device=self.dev)
        wt = torch.as_tensor(weights, device=self.dev).to(torch.int64)
        x, y, w, h = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        st = self.stride
        off = torch.stack([y * st + x, y * st + x + w, (y + h) * st + x, (y + h) * st + x + w], -1)
        out = torch.empty((r.shape[0], self.base.shape[0]), dtype=torch.float32, device=self.dev)
        step = max(1, (1 << 26) // (12 * max(1, self.base.shape[0])))
        for a in range(0, r.shape[0], step):
            g = self.ii[self.base[None, :, None] + off[a:a + step].reshape(-1, 1, 12)]
            g = g.reshape(g.shape[0], -1, 3, 4)
            s = g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]  # exact rect sums
            raw = (s * wt[a:a + step, None, :]).sum(-1).to(torch.float32)  # exact integers
            nf = self.nf[None, :]
            out[a:a + step] = torch.where(nf != 0, raw / torch.where(nf == 0, 1.0, nf), 0.0)
        return out


def stage_accepts(feats: Features, cascade: Cascade, stages) -> torch.Tensor:
    """Samples every stage in ``stages`` accepts."""
    ok = torch.ones(feats.base.shape[0], dtype=torch.bool, device=feats.dev)
    for s in stages:
        v = feats.values(cascade.rects[s.feature], cascade.weights[s.feature])
        split = torch.as_tensor(s.split, device=feats.dev)[:, None]
        leaf = torch.where(v <= split, torch.as_tensor(s.left, device=feats.dev)[:, None],
                           torch.as_tensor(s.right, device=feats.dev)[:, None]).to(torch.float64)
        ok &= leaf.sum(0) >= s.threshold - CV_THRESHOLD_EPS
    return ok


# --------------------------------------------------------------- sampling


def fill_positives(vec: np.ndarray, count: int, cascade: Cascade, stages, device):
    feats = Features(vec.shape[1], device)
    feats.set_samples(vec)
    ok = stage_accepts(feats, cascade, stages).cpu().numpy()
    keep = np.nonzero(ok)[0][:count]
    if len(keep) < count:
        raise RuntimeError(f"the .vec holds {len(keep)} positives the cascade accepts, "
                           f"{count} asked")
    return vec[keep]


def fill_negatives(sched: NegSchedule, count: int, min_acceptance: float, cascade: Cascade,
                   stages, device, counter: dict | None = None):
    """The first ``count`` windows the stages accept, in schedule order;
    stops early, as the trainer does, where the acceptance ratio falls
    to min_acceptance."""
    win, dev = sched.win, torch.device(device)
    kept, consumed = [], 0
    feats = Features(win, dev)
    while len(kept) < count:
        src, (w, h), xs, ys, first = sched.level()
        img = resize_exact(torch.as_tensor(src, device=dev), w, h)
        ii, sq = integral(img), integral(img * img)
        stride = w + 1
        q = first + torch.arange(len(xs) * len(ys) - first, device=dev)
        px = torch.as_tensor(xs, device=dev)[q % len(xs)]
        py = torch.as_tensor(ys, device=dev)[q // len(xs)]
        feats.set_integrals(ii, sq, py * stride + px, stride)
        ok = stage_accepts(feats, cascade, stages).cpu().numpy() if stages else \
            np.ones(len(q), bool)
        n = len(ok)
        kept_before = len(kept) + np.concatenate([[0], np.cumsum(ok[:-1])])
        done = np.arange(n) + consumed  # consumed before each window
        ratio_stop = (done != 0) & ((kept_before + 1) / np.maximum(done, 1) <= min_acceptance)
        full = ok & (kept_before + 1 >= count)
        s = int(np.argmax(ratio_stop)) if ratio_stop.any() else n
        f = int(np.argmax(full)) if full.any() else n
        upper = min(s, f + 1 if f < n else n)
        take = np.nonzero(ok[:upper])[0]
        pxs, pys = px.cpu().numpy(), py.cpu().numpy()
        img_h = img.to(torch.uint8).cpu().numpy() if len(take) else None
        for i in take:
            kept.append(img_h[pys[i]:pys[i] + win, pxs[i]:pxs[i] + win])
        consumed += upper
        if counter is not None:
            counter["windows"] = counter.get("windows", 0) + upper
            counter["tree_evals"] = counter.get("tree_evals", 0) + upper * sum(
                len(st.feature) for st in stages)
        if s <= f and s < n:  # stop before window s
            sched.advance(xs, ys, first, s - 1) if s > 0 else None
            break
        if f < n:
            sched.advance(xs, ys, first, f)
            break
        sched.advance(xs, ys, first, n - 1)
    return (np.stack(kept) if kept else np.zeros((0, win, win), np.uint8)), consumed


# ---------------------------------------------------------------- boosting


@dataclasses.dataclass
class BoostParams:
    min_hit_rate: float = 0.995
    max_false_alarm: float = 0.5
    weight_trim_rate: float = 0.95
    weak_count: int = 100


class Boost:
    """GAB boosting state over one stage's samples, in ``dtype``."""

    def __init__(self, values: torch.Tensor, labels: np.ndarray, params: BoostParams,
                 dtype=torch.float64):
        self.v, self.p, self.dt = values, params, dtype
        dev = values.device
        n = labels.shape[0]
        self.lab = torch.as_tensor(labels, device=dev)
        self.y = (self.lab.to(dtype) * 2 - 1)
        self.w = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
        self.mask = torch.ones(n, dtype=torch.bool, device=dev)
        self.sums = torch.zeros(n, dtype=dtype, device=dev)
        srt = [torch.sort(values[a:a + _BLOCK], dim=1, stable=True)
               for a in range(0, values.shape[0], _BLOCK)]
        self.sorted = torch.cat([t.values for t in srt])
        self.order = torch.cat([t.indices for t in srt])

    def best(self):
        """(quality, feature, f32 threshold) of the best split of the
        trimmed samples; the first maximum in feature order."""
        wm = torch.where(self.mask, self.w, 0)
        best = (-math.inf, -1, 0.0)
        for a in range(0, self.v.shape[0], _BLOCK):
            o = self.order[a:a + _BLOCK]
            vs = self.sorted[a:a + _BLOCK]
            m = self.mask[o]
            w = wm[o]
            lw = torch.cumsum(w, 1)
            ls = torch.cumsum(w * self.y[o], 1)
            tw, ts = lw[:, -1:], ls[:, -1:]
            rw, rs = tw - lw, ts - ls
            # the next trimmed-in value after each position
            big = torch.full_like(vs, math.inf)
            nxt = torch.where(m, vs, big).flip(1).cummin(1).values.flip(1)
            nxt = torch.cat([nxt[:, 1:], big[:, :1]], 1)
            ok = m & (vs + np.float32(2 * FLT_EPSILON) < nxt) & (lw > 0) & (rw > 0)
            q = torch.where(ok, ls * ls / torch.where(ok, lw, 1) + rs * rs / torch.where(ok, rw, 1),
                            -math.inf)
            qm, i = q.max(1)
            f = int(torch.argmax(qm))
            if float(qm[f]) > best[0]:
                j = int(i[f])
                thr = np.float32((np.float32(vs[f, j].item()) + np.float32(nxt[f, j].item()))
                                 * np.float32(0.5))
                best = (float(qm[f]), a + f, thr)
        return best

    def quality(self, left: torch.Tensor) -> float:
        wm = torch.where(self.mask, self.w, 0)
        lw, ls = wm[left].sum(), (wm * self.y)[left].sum()
        rw, rs = wm[~left].sum(), (wm * self.y)[~left].sum()
        if lw <= 0 or rw <= 0:
            return -math.inf
        return float(ls * ls / lw + rs * rs / rw)

    def leaves(self, left: torch.Tensor):
        """Weighted mean response of the trimmed samples on each side, in
        self.dt (f32 leaves are what the trees hold)."""
        wm = torch.where(self.mask, self.w, 0)
        out = []
        for side in (left, ~left):
            out.append(float((wm * self.y)[side].sum() / wm[side].sum()))
        return out

    def update(self, left: torch.Tensor, leaf_l: float, leaf_r: float):
        """Apply a tree with f32 leaves: weights, trimming; returns
        (threshold, false alarm) of the stage so far."""
        f = torch.where(left, float(np.float32(leaf_l)), float(np.float32(leaf_r))).to(self.dt)
        self.sums += f
        self.w = self.w * torch.exp(-self.y * f)
        sw = self.w.sum()
        if float(sw) > FLT_EPSILON:
            self.w = self.w / sw
        if 0 < self.p.weight_trim_rate < 1:
            ws = torch.sort(self.w).values
            cs = torch.cumsum(ws, 0)
            i = int(torch.searchsorted(cs, torch.tensor([1.0 - self.p.weight_trim_rate],
                                                        dtype=cs.dtype, device=cs.device)))
            thr_w = ws[i] if i < len(ws) else math.inf
            self.mask = self.w >= thr_w
        pos = torch.sort(self.sums[self.lab == 1]).values.cpu().numpy()
        num_pos = len(pos)
        t_idx = int((1.0 - self.p.min_hit_rate) * num_pos)
        threshold = float(pos[t_idx])
        neg = self.sums[self.lab == 0]
        fa = float((neg >= threshold - CV_THRESHOLD_EPS).sum()) / max(len(neg), 1)
        return threshold, fa


# ------------------------------------------------------------- the judge


@dataclasses.dataclass
class Corpus:
    vec: np.ndarray  # (n, win, win) uint8 positives, in .vec order
    backgrounds: list  # (h, w) uint8 frames, in bg.txt order
    num_pos: int
    num_neg: int
    num_stages: int
    win: int


def _stage_samples(corpus, cascade, si, sched, params, device, counter):
    """The reference's samples of stage si under the stages before it:
    (samples, labels), or None where the trainer stops before it."""
    stages = cascade.stages[:si]
    pos = fill_positives(corpus.vec, corpus.num_pos, cascade, stages, device)
    n_neg = int(np.rint(corpus.num_neg * len(pos) / corpus.num_pos))
    leaf_fa = params.max_false_alarm ** corpus.num_stages
    neg, consumed = fill_negatives(sched, n_neg, leaf_fa, cascade, stages, device, counter)
    acceptance = len(neg) / consumed if consumed else 0.0
    if len(neg) == 0 or acceptance <= leaf_fa:
        return None
    samples = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos), np.int64), np.zeros(len(neg), np.int64)])
    return samples, labels


def judge(cascade: Cascade, corpus: Corpus, params: BoostParams, device, counter=None) -> dict:
    """Follow a trained cascade stage by stage on the reference's samples
    and weights, taking each tree as trained. Readings (the largest over
    every tree and stage):

      - split_gap: (best quality − the tree's quality) / best quality of
        the trimmed samples, the best over every BASIC feature and split
      - leaf_ulps: f32 ulps between each leaf and the reference's
        weighted mean response on that side, rounded to f32
      - threshold_gap: |stage threshold − the reference's| / |the
        reference's|, each from the f64 sums of the trees' leaves
      - stop_mismatch: stages whose tree count differs from where the
        stop rule ends them, and stages present or missing where the
        reference's fill does or does not stop the training
    """
    dev = torch.device(device)
    rects, weights = haar_basic(corpus.win, corpus.win)
    sched = NegSchedule(corpus.backgrounds, corpus.win)
    out = dict(split_gap=0.0, leaf_ulps=0, threshold_gap=0.0, stop_mismatch=0, trees=0,
               stages=[], features=len(rects), win=corpus.win)
    for si in range(corpus.num_stages):
        got = _stage_samples(corpus, cascade, si, sched, params, dev, counter)
        if got is None or si >= len(cascade.stages):
            out["stop_mismatch"] += int((got is None) != (si >= len(cascade.stages)))
            if got is None:
                break
            continue
        samples, labels = got
        feats = Features(corpus.win, dev)
        feats.set_samples(samples)
        boost = Boost(feats.values(rects, weights), labels, params)
        st = cascade.stages[si]
        thr = fa = None
        for t in range(len(st.feature)):
            q_best = boost.best()[0]
            f = st.feature[t]
            v = feats.values(cascade.rects[f:f + 1], cascade.weights[f:f + 1])[0]
            left = v <= float(st.split[t])
            q = boost.quality(left)
            gap = (q_best - q) / q_best if q_best > 0 else float(q != q_best)
            out["split_gap"] = max(out["split_gap"], min(gap, 1.0))
            for mine, ref in zip((st.left[t], st.right[t]), boost.leaves(left)):
                out["leaf_ulps"] = max(out["leaf_ulps"], ulps(mine, np.float32(ref)))
            thr, fa = boost.update(left, st.left[t], st.right[t])
            stop = fa <= params.max_false_alarm or t + 1 >= params.weak_count \
                or not bool(boost.mask.any())
            if stop != (t == len(st.feature) - 1):
                out["stop_mismatch"] += 1
                break
        out["trees"] += len(st.feature)
        out["stages"].append(dict(samples=len(labels), trees=len(st.feature)))
        if thr is not None:
            out["threshold_gap"] = max(out["threshold_gap"],
                                       abs(st.threshold - thr) / max(abs(thr), 1e-300))
        del boost, feats
    return out


def ulps(a, b) -> int:
    """Distance of two f32 values in units in the last place."""
    ia = int(np.asarray(a, np.float32).view(np.int32))
    ib = int(np.asarray(b, np.float32).view(np.int32))
    ia = ia if ia >= 0 else -(ia & 0x7FFFFFFF)
    ib = ib if ib >= 0 else -(ib & 0x7FFFFFFF)
    return abs(ia - ib)


FAULTS = ("frozen", "half", "leaf", "truncate", "threshold")


def train(corpus: Corpus, params: BoostParams, device, dtype=torch.float64,
          fault: str | None = None) -> Cascade:
    """The reference choosing its own trees: in f32, the control; with a
    fault, a broken trainer whose readings set the limits: "frozen"
    leaves the weights as they were after each tree, "half" searches
    splits and takes leaf means over every other sample only, "leaf"
    alters each stage's first leaf by one part in 10^4, "truncate" ends
    each stage after its first tree, "threshold" writes each stage's
    threshold less CV_THRESHOLD_EPS (the runtime's margin taken twice)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    dev = torch.device(device)
    rects, weights = haar_basic(corpus.win, corpus.win)
    sched = NegSchedule(corpus.backgrounds, corpus.win)
    used, stages = [], []
    cascade = Cascade(corpus.win, corpus.win, stages, np.zeros((0, 3, 4), np.int64),
                      np.zeros((0, 3), np.float32))
    for si in range(corpus.num_stages):
        got = _stage_samples(corpus, cascade, si, sched, params, dev, None)
        if got is None:
            break
        samples, labels = got
        feats = Features(corpus.win, dev)
        feats.set_samples(samples)
        values = feats.values(rects, weights)
        boost = Boost(values, labels, params, dtype)
        half = torch.arange(len(labels), device=dev) % 2 == 0
        feat, split, ll, rl = [], [], [], []
        while True:
            if fault == "half":
                boost.mask &= half
            _, f, thr = boost.best()
            left = values[f] <= float(thr)
            a, b = (np.float32(x) for x in boost.leaves(left))
            if fault == "leaf" and not feat:
                a = np.float32(a * np.float32(1.0001))
            w = boost.w
            threshold, fa = boost.update(left, a, b)
            if fault == "frozen":
                boost.w = w
            if f not in used:
                used.append(f)
            feat.append(used.index(f))
            split.append(thr)
            ll.append(a)
            rl.append(b)
            if fa <= params.max_false_alarm or len(feat) >= params.weak_count \
                    or not bool(boost.mask.any()) or fault == "truncate":
                break
        if fault == "threshold":
            threshold -= CV_THRESHOLD_EPS
        stages.append(Stage(threshold=float(threshold), feature=np.asarray(feat, np.int64),
                            split=np.asarray(split, np.float32), left=np.asarray(ll, np.float32),
                            right=np.asarray(rl, np.float32)))
        cascade = Cascade(corpus.win, corpus.win, stages, rects[used], weights[used])
        del boost, values, feats
    return cascade
