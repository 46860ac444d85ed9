"""Training-side cascade predictor for sample filtering.

Counterpart of ``cascadeclassifier_tpu/train/predictor.py::
CascadePredictor`` for stump cascades: CvCascadeClassifier::predict →
CvCascadeBoost::predict (cascadeclassifier.cpp:297-306, boost.cpp:461-477)
with the training evaluator's feature values, ``val <= thr`` stumps (Haar)
or the subset bit of the code (LBP), leaves summed in f64 and a stage
rejecting at ``sum < threshold − 1e-5``.

``predict_batch`` filters positives; ``predict_levels`` is the dense
miner: for each (image, scale) level it crops the window grid from the
level (resized on the device from its source for lazy levels), takes
every window's integrals and the corner product with the used features
(Haar: upright plus tilted, then the division by the norm factor; LBP:
the 9 cell sums, then the 8 compares) and the stump walk, one fetch per
superbatch. The JAX package's pow2 and ladder padding and its compile
caches bound XLA compiles; the masks do not depend on them and they are
not ported. Deep-tree and HOG cascades (its per-window gather path)
raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch.ops.integral import integral_tilted
from cascadeclassifier_tpu_torch.ops.resize import build_level
from cascadeclassifier_tpu_torch.train.evaluators import divide_nf, f32_matmul, haar_rows, lbp_rows
from cascadeclassifier_tpu_torch.train.split import scan_cumsum
from cascadeclassifier_tpu_torch.utils.profiling import timed

CV_THRESHOLD_EPS = 1e-5


def stump_walk(vals, ti, tt, tl, tr, ts, bs, be, sthr):
    """All-stump cascade walk (boost.cpp:461-477): vals (K, m) f32 feature
    values (int32 codes for a categorical cascade); per tree its value row
    ti, threshold tt (f32) or subset ts (T, 8) int32 (categorical; None
    otherwise) and leaves tl, tr (f32, summed in f64); stage s owns trees
    [bs[s], be[s]). A code c goes left when bit c & 31 of word c >> 5 of
    the subset is set. Stage sums are differences of one f64 prefix over
    the tree axis, in the order XLA:CPU adds ``jnp.cumsum`` in the JAX
    package. → (m,) bool accepts."""
    tv = vals[ti]
    if ts is None:
        left = tv <= tt[:, None]
    else:
        word = ts.gather(1, (tv >> 5).long())
        left = ((word >> (tv & 31)) & 1) != 0
    leaf = torch.where(left, tl[:, None], tr[:, None]).to(torch.float64)
    pref = scan_cumsum(leaf)
    ends = pref[be - 1]
    starts = torch.where((bs > 0)[:, None], pref[(bs - 1).clamp(min=0)], 0.0)
    rej = (ends - starts) < sthr[:, None] - CV_THRESHOLD_EPS
    return ~rej.any(dim=0)


class CascadePredictor:
    """Accept/reject of the current (partial) cascade on batches."""

    SRC_CACHE_CAP = 256
    CHUNK_WINDOWS = 65536  # windows a device pass takes at most

    def __init__(self, evaluator_factory, stages=None):
        """evaluator_factory: () → a training evaluator over the full catalog."""
        self._make_ev = evaluator_factory
        self.stages = list(stages or [])
        self._src_cache = {}

    def _used_vars(self):
        return sorted({int(v) for s in self.stages for t in s.trees for v in t.feature_idx})

    def _tables(self, used, device, categorical: bool):
        """Per-tree tensors for stump_walk."""
        pos = {v: i for i, v in enumerate(used)}
        ti, tt, tl, tr, ts, bounds, sthr = [], [], [], [], [], [0], []
        for stage in self.stages:
            for tree in stage.trees:
                if tree.num_nodes != 1:
                    raise NotImplementedError("the port's predictor walks stump cascades only")
                ti.append(pos[int(tree.feature_idx[0])])
                if categorical:
                    ts.append(np.asarray(tree.subsets[0], np.int32))
                    tt.append(0.0)
                else:
                    tt.append(tree.threshold[0])
                tl.append(tree.leaf_values[-int(tree.left[0])] if tree.left[0] <= 0 else 0.0)
                tr.append(tree.leaf_values[-int(tree.right[0])] if tree.right[0] <= 0 else 0.0)
            bounds.append(len(ti))
            sthr.append(float(stage.threshold))

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        return (t(ti, np.int64), t(tt, np.float32), t(tl, np.float32), t(tr, np.float32),
                t(ts, np.int32) if categorical else None,
                t(bounds[:-1], np.int64), t(bounds[1:], np.int64), t(sthr, np.float64))

    def predict_batch(self, samples) -> np.ndarray:
        """samples: (m, h, w) uint8 → (m,) bool, True when every stage
        accepts (1 == the reference's predict)."""
        m = samples.shape[0]
        if not self.stages or m == 0:
            return np.ones(m, bool)
        ev = self._make_ev()
        used = self._used_vars()
        ev.set_samples(samples)
        vals = ev.values_for_vars(used)
        tables = self._tables(used, ev.device, ev.maxCatCount > 0)
        return stump_walk(vals, *tables).cpu().numpy()

    def _source(self, lvl, device):
        key = lvl.src_id
        dev = self._src_cache.get(key)
        if dev is None:
            if len(self._src_cache) >= self.SRC_CACHE_CAP:
                self._src_cache.clear()
            dev = torch.from_numpy(np.ascontiguousarray(lvl.src)).to(device)
            self._src_cache[key] = dev
        return dev

    def _level_windows(self, img, pos, ww, wh, device):
        """The windows at pos (m, 2) (px, py) of one level, on the device,
        in pos order: the level's grid from the first window's row and
        column, cut from the level (built from its source for a lazy
        level) by strided views."""
        sy, sx = wh // 2, ww // 2
        ox, oy = int(pos[:, 0].min()), int(pos[:, 1].min())
        iy = torch.as_tensor((pos[:, 1] - oy) // sy, dtype=torch.int64, device=device)
        ix = torch.as_tensor((pos[:, 0] - ox) // sx, dtype=torch.int64, device=device)
        ny, nx = int((pos[:, 1] - oy).max()) // sy + 1, int((pos[:, 0] - ox).max()) // sx + 1
        hs, ws = sy * (ny - 1) + wh, sx * (nx - 1) + ww
        if hasattr(img, "src"):  # a LazyLevel
            src = self._source(img, device)
            slot = build_level(src, img.src.shape[0], img.src.shape[1], img.h, img.w,
                               oy, ox, hs, ws)
        else:
            slot = torch.from_numpy(np.ascontiguousarray(img[oy:oy + hs, ox:ox + ws])).to(device)
        grid = slot.unfold(0, wh, sy).unfold(1, ww, sx)  # (ny, nx, wh, ww)
        return grid[iy, ix]

    def predict_levels(self, levels, ww: int, wh: int):
        """Mining predict over whole (image, scale) levels.

        levels: list of (img, positions, cache_key); img an (H, W) uint8
        array or a LazyLevel. → per-level (len(positions),) bool masks."""
        if not self.stages:
            return [np.ones(len(lv[1]), bool) for lv in levels]
        ev = self._make_ev()
        dev = ev.device
        used = self._used_vars()
        sel = torch.as_tensor(used, device=dev)
        if ev.maxCatCount > 0:
            m_cells = ev.cell_matrix(sel)

            def values(win):
                return ev.codes(m_cells, lbp_rows(win))
        else:
            m_up, m_tilt = ev.corner_matrices(sel)

            def values(win):
                rows, nf = haar_rows(win)
                raw = f32_matmul(m_up, rows.T)
                if m_tilt is not None:  # up + tilted, then the division
                    t = integral_tilted(win)
                    raw = raw + f32_matmul(m_tilt, t.reshape(t.shape[0], -1).to(torch.float32).T)
                return divide_nf(raw, nf)

        tables = self._tables(used, dev, ev.maxCatCount > 0)
        counts = [len(lv[1]) for lv in levels]
        oks = []
        with timed("mine_values"):
            wins = [self._level_windows(img, pos, ww, wh, dev)
                    for img, pos, _key in levels if len(pos)]
            wins = torch.cat(wins) if wins else torch.zeros((0, wh, ww), dtype=torch.uint8)
            for c0 in range(0, wins.shape[0], self.CHUNK_WINDOWS):
                oks.append(stump_walk(values(wins[c0:c0 + self.CHUNK_WINDOWS]), *tables))
        with timed("mine_fetch"):
            ok = torch.cat(oks).cpu().numpy() if oks else np.zeros(0, bool)
        out, off = [], 0
        for c in counts:
            out.append(ok[off:off + c])
            off += c
        return out
