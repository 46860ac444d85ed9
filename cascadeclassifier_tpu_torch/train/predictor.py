"""Training-side cascade predictor for sample filtering.

Counterpart of ``cascadeclassifier_tpu/train/predictor.py::
CascadePredictor``: CvCascadeClassifier::predict →
CvCascadeBoost::predict (cascadeclassifier.cpp:297-306, boost.cpp:461-477)
with the training evaluator's feature values, ``val <= thr`` stumps (Haar)
or the subset bit of the code (LBP), leaves summed in f64 and a stage
rejecting at ``sum < threshold − 1e-5``.

``predict_batch`` filters positives; ``predict_levels`` is the miner,
over whole (image, scale) levels. The dispatch is the JAX package's:

- every tree a stump and one value a feature (Haar, LBP): the dense
  path, ``train/mine.py``: the levels packed into a table and a source
  arena (``pack_levels``), then ``mine``, one launch of ``csrc/mine.cu``
  a superbatch on a CUDA device (its plain version ``mine_ref`` on the
  CPU): each window's pixels, integrals and norm factor, the used
  features' values (Haar: the rect sums over the norm factor; LBP: the 9
  cell sums, then the 8 compares) and the stump walk;
- every tree a stump and 36 values a feature (HOG): the window grid of
  each level cropped from the level (resized on the device from its
  source for lazy levels), the evaluator's ``set_samples`` on the
  windows, ``values_for_vars`` and ``stump_walk``;
- any tree deeper than a stump: the same values and ``tree_walk``, whose
  stage sums start from 0 and add each tree's leaf in tree order (the
  JAX package's host walk, predictor.py:790-819), a rounding that differs
  from stump_walk's prefix differences.

One fetch per superbatch. The JAX package's pow2 and ladder padding and
its compile caches bound XLA compiles; the masks do not depend on them
and they are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch.train import mine
from cascadeclassifier_tpu_torch.train.split import scan_cumsum
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count, span

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


def tree_walk(vals, fpos, thr, sub, left, right, leaves, roots, depth, bounds, sthr):
    """Cascade walk of trees of any depth (boost.cpp:461-477, the JAX
    package's host walk): vals (K, m) feature values (int32 codes for a
    categorical cascade); the nodes of every tree in one table: value row
    fpos, threshold thr (f32) or subset sub (nodes, 8) int32, children
    left/right (>= 0 a node, -(leaf) - 1 a leaf of ``leaves``); roots (T,)
    each tree's root; depth the longest root-to-leaf path; stage s owns
    trees bounds[s]:bounds[s + 1] with threshold sthr[s] (floats). Every
    tree walks every window at once, ``depth`` steps; the stage sum starts
    from 0 and adds each tree's leaf (f32 → f64) in tree order. →
    (m,) bool accepts."""
    m = vals.shape[1]
    cols = torch.arange(m, device=vals.device)
    cur = roots[:, None].expand(roots.shape[0], m)
    for _ in range(depth):
        node = cur.clamp(min=0)
        v = vals[fpos[node], cols]
        if sub is None:
            gl = v <= thr[node]
        else:
            gl = ((sub[node, (v >> 5).long()] >> (v & 31)) & 1) != 0
        cur = torch.where(cur >= 0, torch.where(gl, left[node], right[node]), cur)
    leaf = leaves[-cur - 1].to(torch.float64)
    ok = torch.ones(m, dtype=torch.bool, device=vals.device)
    for s, thr_s in enumerate(sthr):
        acc = torch.zeros(m, dtype=torch.float64, device=vals.device)
        for t in range(bounds[s], bounds[s + 1]):
            acc = acc + leaf[t]
        ok &= ~(acc < thr_s - CV_THRESHOLD_EPS)
    return ok


def _split(ok, counts) -> list:
    """A superbatch's mask → one mask a level, counts[i] long each."""
    offs = np.concatenate(([0], np.cumsum(counts, dtype=np.int64)))
    return [ok[a:b] for a, b in zip(offs[:-1], offs[1:])]


def _tree_depth(tree, ni=0) -> int:
    d = 0
    for c in (int(tree.left[ni]), int(tree.right[ni])):
        d = max(d, _tree_depth(tree, c) if c > 0 else 0)
    return d + 1


class CascadePredictor:
    """Accept/reject of the current (partial) cascade on batches."""

    def __init__(self, evaluator_factory, stages=None):
        """evaluator_factory: () → a training evaluator over the full catalog."""
        self._make_ev = evaluator_factory
        self.stages = list(stages or [])
        self._arena = None
        self._walk_key = self._walk = None
        self._feats_key = self._feats = None

    def _used_vars(self):
        return sorted({int(v) for s in self.stages for t in s.trees for v in t.feature_idx})

    def _all_stumps(self) -> bool:
        return all(t.num_nodes == 1 for s in self.stages for t in s.trees)

    def _node_tables(self, used, device, categorical: bool):
        """The node table of every tree for tree_walk."""
        pos = {v: i for i, v in enumerate(used)}
        fpos, thr, sub, left, right, leaves, roots, bounds, sthr = ([] for _ in range(9))
        bounds.append(0)
        depth = 0
        for stage in self.stages:
            for tree in stage.trees:
                n0, l0 = len(fpos), len(leaves)
                roots.append(n0)
                depth = max(depth, _tree_depth(tree))
                for ni in range(tree.num_nodes):
                    fpos.append(pos[int(tree.feature_idx[ni])])
                    if categorical:
                        sub.append(np.asarray(tree.subsets[ni], np.int32))
                        thr.append(0.0)
                    else:
                        thr.append(tree.threshold[ni])
                    for out, c in ((left, int(tree.left[ni])), (right, int(tree.right[ni]))):
                        out.append(n0 + c if c > 0 else -(l0 - c) - 1)
                leaves.extend(np.asarray(tree.leaf_values, np.float32))
            bounds.append(len(roots))
            sthr.append(float(stage.threshold))

        def t(a, dtype):
            count(SYNC)
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        return (t(fpos, np.int64), t(thr, np.float32), t(sub, np.int32) if categorical else None,
                t(left, np.int64), t(right, np.int64), t(leaves, np.float32), t(roots, np.int64),
                depth, bounds, sthr)

    def _walk_of(self, ev):
        """(the used features, values (K, m) → (m,) accepts, the dense
        miner's Trees or None): stump_walk when every tree is a stump,
        tree_walk otherwise; the tables are built once for a given set of
        stages."""
        key = (len(self.stages), sum(len(s.trees) for s in self.stages), ev.device)
        if self._walk_key != key:
            used, cat = self._used_vars(), ev.maxCatCount > 0
            if self._all_stumps():
                trees = mine.tree_table(self.stages, used, cat, ev.device)
                tables = mine.walk_args(trees)
                self._walk = (used, lambda vals: stump_walk(vals, *tables), trees)
            else:
                tables = self._node_tables(used, ev.device, cat)
                self._walk = (used, lambda vals: tree_walk(vals, *tables), None)
            self._walk_key = key
        return self._walk

    def _predict_windows(self, ev, used, walk, windows):
        """(m, h, w) uint8 windows on the device → (m,) bool on the device:
        the evaluator's values of the used features, then the walk."""
        ev.set_samples(windows)
        return walk(ev.values_for_vars(used))

    def predict_device(self, samples):
        """samples: (m, h, w) uint8 → (m,) bool on the evaluator's device,
        True when every stage accepts."""
        ev = self._make_ev()
        if not self.stages or samples.shape[0] == 0:
            return torch.ones(samples.shape[0], dtype=torch.bool, device=ev.device)
        used, walk, _trees = self._walk_of(ev)
        return self._predict_windows(ev, used, walk, samples)

    def predict_batch(self, samples) -> np.ndarray:
        """samples: (m, h, w) uint8 → (m,) bool, True when every stage
        accepts (1 == the reference's predict)."""
        ok = self.predict_device(samples)
        count(SYNC)
        return ok.cpu().numpy()

    def predict_levels(self, levels, ww: int, wh: int):
        """Mining predict over whole (image, scale) levels.

        levels: list of (img, positions, cache_key); img an (H, W) uint8
        array or a LazyLevel, positions a GridRun (read in O(1), never
        built) or an (m, 2) array. → per-level (len(positions),) bool
        masks."""
        if not self.stages:
            return [np.ones(len(lv[1]), bool) for lv in levels]
        ev = self._make_ev()
        if not self._all_stumps() or getattr(ev, "featSize", 1) != 1:
            return self._predict_levels_gather(ev, levels, ww, wh)
        used, _walk, trees = self._walk_of(ev)
        if self._feats_key != self._walk_key:
            self._feats, self._feats_key = mine.features_of(ev, used), self._walk_key
        with span("mine.values"):
            packed = self._pack(levels, ww, wh, ev.device)
            ok = mine.mine(packed, self._feats, trees, ww, wh)
        with span("mine.fetch"):
            count(SYNC)
            ok = ok.cpu().numpy().astype(bool)
        return _split(ok, packed.counts)

    def _pack(self, levels, ww: int, wh: int, device):
        """The levels' table, their lazy sources in this predictor's arena."""
        if self._arena is None or self._arena.device != torch.device(device):
            self._arena = mine.SourceArena(device)
        return mine.pack_levels(levels, ww, wh, device, self._arena)

    def _predict_levels_gather(self, ev, levels, ww: int, wh: int):
        """Deep-tree and HOG cascades: the windows of each level cut from
        the level (built from its source for a lazy level), the
        evaluator's values of the used features, the walk."""
        used, walk, _trees = self._walk_of(ev)
        oks = []
        with span("mine.values"):
            packed = self._pack(levels, ww, wh, ev.device)
            wins = mine.level_windows(packed, ww, wh)
            for c0 in range(0, wins.shape[0], mine.CHUNK_WINDOWS):
                oks.append(self._predict_windows(ev, used, walk,
                                                 wins[c0:c0 + mine.CHUNK_WINDOWS]))
        with span("mine.fetch"):
            count(SYNC)
            ok = torch.cat(oks).cpu().numpy() if oks else np.zeros(0, bool)
        return _split(ok, packed.counts)
