"""Standalone CART decision trees (the reference's L1 ML core).

Counterpart of ``cascadeclassifier_tpu/train/dtree.py``, whose numpy
paths are copied here; its clean binary and regression split search, which
calls the boosted trainer's XLA splits (``_kernel_best_split``,
dtree.py:491), calls the port's split kernels instead: ``split_scan_gather``
and ``split_scan_class_gather`` (Gini) on the ordered columns, in numpy's
argsort order as the JAX package sorts them, ``categorical_split`` and
``categorical_class_split`` on the categorical ones. Those run on
``device`` ("cuda" unless the caller asks for the CPU, where the plain
versions run).

Covers the capability surface of CvDTree (o_cvdtree.cpp) as used and tested
by the reference (test_dtree.cpp): binary classification (weighted Gini)
and regression (weighted squared-error) on ordered and categorical
variables, depth / min-sample stopping, sample-index masking, priors, and
cost-complexity pruning selected by k-fold cross-validation with the
optional 1-SE rule (prune_cv, o_cvdtree.cpp:1561-1690).

The split search reuses the same vectorized device kernels as the boosted
trainer (a (D, N) block scan per node — the moral opposite of the
reference's per-variable serial loops). Pruning follows the standard CART
weakest-link construction; the reference's fold bookkeeping differs in
detail, so pruned trees are behaviorally (not node-for-node) equivalent.

Full CvDTree capability surface:
  - >2-class classification (calc_node_value / find_split_ord_class
    multiclass branches, o_cvdtree.cpp:359-469, 1074-1173): per-class
    weighted Gini, majority-class leaves under priors
  - categorical multiclass splits via k-means category clustering to
    max_categories (cluster_categories, o_cvdtree.cpp:470-547) followed
    by the exhaustive Gray-code subset scan (o_cvdtree.cpp:549-713)
  - surrogate splits for missing values (NaN inputs):
    find_surrogate_split_* (o_cvdtree.cpp:860-1059) — per node, other
    variables ranked by weighted agreement with the primary direction,
    used at predict time when the primary value is missing, with the
    majority-branch default as the last resort (o_cvdtree.cpp:1762-1869)
These paths run in numpy (standalone-library scale); the clean binary /
regression case keeps the vectorized device kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cascadeclassifier_tpu_torch.train.cat_split import categorical_class_split, categorical_split
from cascadeclassifier_tpu_torch.train.split import (
    split_scan_class_gather,
    split_scan_gather,
    tree_sum,
)


@dataclasses.dataclass
class DTreeParams:
    """Defaults mirror CvDTreeParams (o_cvdtreeparams.cpp:5-29)."""

    max_depth: int = 2**31 - 1
    min_sample_count: int = 10
    cv_folds: int = 10
    use_1se_rule: bool = True
    regression_accuracy: float = 0.01
    priors: np.ndarray | None = None  # (n_classes,) class priors
    use_surrogates: bool = True
    max_categories: int = 10


@dataclasses.dataclass
class _Node:
    leaf_value: float
    n: int
    risk: float  # training risk of this node as a leaf
    var: int = -1
    thr: float = 0.0
    subset: np.ndarray | None = None
    left: "_Node | None" = None
    right: "_Node | None" = None
    # missing-value routing (o_cvdtree.cpp:860-1059, :1762-1869):
    # surrogates = [(var, thr, subset|None, swap)] in descending agreement
    surrogates: list = dataclasses.field(default_factory=list)
    default_left: bool = True

    def is_leaf(self):
        return self.left is None


def cluster_categories(cjk: np.ndarray, k: int, rng=None) -> np.ndarray:
    """k-means over category class-count vectors
    (cluster_categories, o_cvdtree.cpp:470-547): vectors are weighted by
    1/rowsum, centroids by 1/clustersum, distance on the reweighted
    vectors; returns (n_categories,) cluster labels in [0, k)."""
    n, m = cjk.shape
    rng = rng or np.random.default_rng(0)
    labels = np.where(np.arange(n) < k, np.arange(n), rng.integers(0, k, n))
    rng.shuffle(labels)
    v_w = np.where(cjk.sum(1) > 0, 1.0 / np.maximum(cjk.sum(1), 1), 0.0)
    for _ in range(100):
        csums = np.zeros((k, m))
        np.add.at(csums, labels, cjk)
        c_w = np.where(csums.sum(1) > 0, 1.0 / np.maximum(csums.sum(1), 1e-300), 0.0)
        # dist²(i, c) = || v_i·α_i − s_c·β_c ||²
        diff = cjk[:, None, :] * v_w[:, None, None] - csums[None] * c_w[None, :, None]
        new = np.argmin((diff * diff).sum(2), axis=1)
        if np.array_equal(new, labels):
            break
        labels = new
    return labels


class DecisionTree:
    """CART for binary classification or regression.

    X: (N, D) float32 feature matrix; categorical columns hold integer
    codes in [0, 256) and are declared via ``categorical`` (list of column
    indices). y: (N,) {0,1} for classification, float for regression.
    """

    def __init__(
        self,
        params: DTreeParams | None = None,
        regression: bool = False,
        categorical=(),
        device="cuda",
    ):
        self.params = params or DTreeParams()
        self.regression = regression
        self.categorical = frozenset(categorical)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DecisionTree(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to fit on the host")
        self.root = None

    # ------------------------------------------------------------ fitting

    def fit(self, X, y, sample_weight=None, sample_idx=None):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        n = len(X)
        w = (
            np.asarray(sample_weight, np.float64)
            if sample_weight is not None
            else np.ones(n)
        )
        self.n_classes = (
            0 if self.regression else int(np.nanmax(y)) + 1
        )
        if not self.regression and self.params.priors is not None:
            pr = np.asarray(self.params.priors, np.float64)
            cls_w = pr / np.maximum(
                np.bincount(y.astype(int), minlength=self.n_classes), 1
            )
            w = w * cls_w[y.astype(int)]
        mask = np.zeros(n, bool)
        if sample_idx is not None:
            mask[np.asarray(sample_idx)] = True
        else:
            mask[:] = True

        self._X = X
        self._has_missing = bool(np.isnan(X).any())
        self._ord_cols = [d for d in range(X.shape[1]) if d not in self.categorical]
        self._cat_cols = sorted(self.categorical)
        self._Xo = np.ascontiguousarray(X[:, self._ord_cols].T)  # (Do, N)
        self._so = np.argsort(self._Xo, axis=1).astype(np.int32)
        self._Xc = (
            np.ascontiguousarray(
                np.nan_to_num(X[:, self._cat_cols].T, nan=0.0).astype(
                    np.int32
                )
            )
            if self._cat_cols
            else None
        )
        # the kernel path's inputs on the device: the ordered columns'
        # sorted values and sort order as (N, Do) views, the codes (Dc, N)
        dev = self.device
        so = torch.from_numpy(self._so.astype(np.int64)).to(dev)
        self._vs_dev = torch.from_numpy(self._Xo).to(dev).gather(1, so).t()
        self._so_dev = so.t()
        self._xc_dev = None if self._Xc is None else torch.from_numpy(self._Xc).to(dev)
        self.root = self._grow(w, y, mask, 0)
        if self.params.cv_folds > 1 and mask.sum() >= 2 * self.params.cv_folds:
            self._prune(X, y, w, mask)
        return self

    def _leaf_stats(self, y, w, mask):
        wm = w * mask
        sw = wm.sum()
        if self.regression:
            mean = float((wm * y).sum() / sw) if sw > 0 else 0.0
            risk = float((wm * (y - mean) ** 2).sum())
            return mean, risk
        # majority class under weights/priors (calc_node_value,
        # o_cvdtree.cpp:1074-1173); risk = weighted misclassification
        cw = np.zeros(max(self.n_classes, 2))
        np.add.at(cw, y[mask].astype(int), wm[mask])
        value = float(np.argmax(cw))
        risk = float(sw - cw.max())
        return value, risk

    def _grow(self, w, y, mask, depth) -> _Node:
        count = int(mask.sum())
        value, risk = self._leaf_stats(y, w, mask)
        node = _Node(leaf_value=value, n=count, risk=risk)
        p = self.params
        if depth >= p.max_depth or count <= p.min_sample_count:
            return node
        if self.regression:
            # regression_accuracy stop (o_cvdtree.cpp try_split_node)
            wm = (w * mask).sum()
            if wm > 0 and np.sqrt(risk / wm) < p.regression_accuracy:
                return node
        elif risk == 0.0:
            return node

        best = self._best_split(w, y, mask)
        if best is None:
            return node
        kind, var, payload, _q = best
        known = ~np.isnan(self._X[:, var])
        if kind == "ord":
            vals = self._Xo[self._ord_cols.index(var)]
            go_left = known & (vals <= payload)
            node.var, node.thr = var, float(payload)
        else:
            ci = self._cat_cols.index(var)
            codes = np.where(known, self._Xc[ci], 0).astype(np.int64)
            bits = (
                np.asarray(payload, np.uint32)[codes >> 5] >> (codes & 31)
            ) & 1
            go_left = known & (bits != 0)
            node.var, node.subset = var, np.asarray(payload, np.int32)

        # missing-value routing: surrogate splits, then the majority
        # branch (complete_node_dir, o_cvdtree.cpp:1247-1320)
        node.default_left = bool(
            (w * (mask & go_left)).sum() >= (w * (mask & known & ~go_left)).sum()
        )
        if self._has_missing and self.params.use_surrogates:
            node.surrogates = self._find_surrogates(
                w, mask, go_left, known, var
            )
        miss = mask & ~known
        if miss.any():
            go_left = go_left.copy()
            resolved = known.copy()
            for (svar, sthr, ssub, swap) in node.surrogates:
                sk = ~resolved & ~np.isnan(self._X[:, svar])
                if not sk.any():
                    continue
                if ssub is None:
                    sl = self._X[sk, svar] <= sthr
                else:
                    codes = self._X[sk, svar].astype(np.int64)
                    sl = (
                        (ssub.astype(np.uint32)[codes >> 5] >> (codes & 31))
                        & 1
                    ) != 0
                go_left[sk] = sl ^ swap
                resolved |= sk
            go_left[~resolved] = node.default_left
        lmask = mask & go_left
        rmask = mask & ~go_left
        if lmask.sum() == 0 or rmask.sum() == 0:
            node.var = -1
            node.subset = None
            node.surrogates = []
            return node
        node.left = self._grow(w, y, lmask, depth + 1)
        node.right = self._grow(w, y, rmask, depth + 1)
        return node

    def _find_surrogates(self, w, mask, go_left, known, primary_var,
                         max_surrogates: int = 10):
        """Surrogate splits ranked by weighted agreement with the primary
        direction (find_surrogate_split_ord/cat, o_cvdtree.cpp:860-1059).
        A candidate is kept only when it beats the trivial
        send-everything-to-the-majority-branch baseline."""
        dmask = mask & known  # samples with a known primary direction
        wL = float((w * (dmask & go_left)).sum())
        wR = float((w * (dmask & ~go_left)).sum())
        base = max(wL, wR)
        found = []
        for var in range(self._X.shape[1]):
            if var == primary_var:
                continue
            vk = dmask & ~np.isnan(self._X[:, var])
            if vk.sum() < 2:
                continue
            wl = np.where(vk & go_left, w, 0.0)
            wr = np.where(vk & ~go_left, w, 0.0)
            if var in self.categorical:
                codes = np.where(vk, self._X[:, var], 0).astype(np.int64)
                cl = np.zeros(256)
                cr = np.zeros(256)
                np.add.at(cl, codes[vk], wl[vk])
                np.add.at(cr, codes[vk], wr[vk])
                # per-category majority vote
                take_left = cl > cr
                agree = float(np.where(take_left, cl, cr).sum())
                if agree <= base + 1e-12:
                    continue
                bits = np.zeros(256, bool)
                bits[take_left] = True
                subset = np.zeros(8, np.uint32)
                for j in np.nonzero(bits)[0]:
                    subset[j >> 5] |= np.uint32(1) << np.uint32(j & 31)
                found.append((var, 0.0, subset.astype(np.int32), False,
                              agree))
            else:
                v = self._X[:, var]
                order = np.argsort(v[vk], kind="stable")
                vv = v[vk][order]
                cwl = np.cumsum(wl[vk][order])
                cwr = np.cumsum(wr[vk][order])
                tl, tr = cwl[-1], cwr[-1]
                ok = vv[:-1] + 2 * np.finfo(np.float32).eps < vv[1:]
                if not ok.any():
                    continue
                # agreement for (left≤thr): left weight below + right above
                same = cwl[:-1] + (tr - cwr[:-1])
                swap = cwr[:-1] + (tl - cwl[:-1])
                same = np.where(ok, same, -np.inf)
                swap = np.where(ok, swap, -np.inf)
                bi_s, bi_w = int(np.argmax(same)), int(np.argmax(swap))
                if same[bi_s] >= swap[bi_w]:
                    agree, bi, do_swap = float(same[bi_s]), bi_s, False
                else:
                    agree, bi, do_swap = float(swap[bi_w]), bi_w, True
                if agree <= base + 1e-12:
                    continue
                thr = float(
                    (np.float32(vv[bi]) + np.float32(vv[bi + 1]))
                    * np.float32(0.5)
                )
                found.append((var, thr, None, do_swap, agree))
        found.sort(key=lambda t: -t[4])
        return [(v, t, s, sw) for (v, t, s, sw, _q) in found[:max_surrogates]]

    def _best_split(self, w, y, mask):
        if self._has_missing or (not self.regression and self.n_classes > 2):
            return self._np_best_split(w, y, mask)
        return self._kernel_best_split(w, y, mask)

    def _np_best_split(self, w, y, mask):
        """Numpy split search covering the CvDTree paths the device
        kernels do not: per-variable missing masks and >2-class Gini
        (find_split_ord_class multiclass, find_split_cat_class with
        cluster_categories)."""
        K = max(self.n_classes, 1)
        eps2 = 2 * np.finfo(np.float32).eps
        best = None  # (kind, var, payload, q)

        def consider(kind, var, payload, q):
            nonlocal best
            if np.isfinite(q) and (best is None or q > best[3]):
                best = (kind, var, payload, q)

        for di, var in enumerate(self._ord_cols):
            v = self._Xo[di]
            vk = mask & ~np.isnan(v)
            n_v = int(vk.sum())
            if n_v < 2:
                continue
            order = np.argsort(v[vk], kind="stable")
            vv = v[vk][order]
            ww = w[vk][order]
            ok = vv[:-1] + eps2 < vv[1:]
            if not ok.any():
                continue
            lw = np.cumsum(ww)[:-1]
            rw = lw[-1] + ww[-1] - lw
            if self.regression:
                wr = (ww * y[vk][order])
                lr = np.cumsum(wr)[:-1]
                rr = lr[-1] + wr[-1] - lr
                q = np.where(
                    ok & (lw > 0) & (rw > 0),
                    (lr * lr * rw + rr * rr * lw) / (lw * rw),
                    -np.inf,
                )
            else:
                yy = y[vk][order].astype(int)
                cw = np.zeros((len(ww), K))
                cw[np.arange(len(ww)), yy] = ww
                lc = np.cumsum(cw, axis=0)[:-1]
                rc = lc[-1] + cw[-1] - lc
                lsum2 = (lc * lc).sum(1)
                rsum2 = (rc * rc).sum(1)
                q = np.where(
                    ok & (lw > 0) & (rw > 0),
                    lsum2 / np.maximum(lw, 1e-300)
                    + rsum2 / np.maximum(rw, 1e-300),
                    -np.inf,
                )
            bi = int(np.argmax(q))
            if np.isfinite(q[bi]):
                thr = np.float32(
                    (np.float32(vv[bi]) + np.float32(vv[bi + 1]))
                    * np.float32(0.5)
                )
                consider("ord", var, thr, float(q[bi]))

        for ci, var in enumerate(self._cat_cols):
            vraw = self._X[:, var]
            vk = mask & ~np.isnan(vraw)
            if vk.sum() < 2:
                continue
            codes = self._Xc[ci]
            if self.regression:
                # weighted per-category mean sort + prefix scan
                cw = np.zeros(256)
                cs = np.zeros(256)
                np.add.at(cw, codes[vk], w[vk])
                np.add.at(cs, codes[vk], (w * y)[vk])
                used = cw > 0
                means = np.where(used, cs / np.maximum(cw, 1e-300), 0.0)
                order = np.argsort(means, kind="stable")
                lw = np.cumsum(cw[order])[:-1]
                lr = np.cumsum(cs[order])[:-1]
                rw = lw[-1] + cw[order][-1] - lw
                rr = lr[-1] + cs[order][-1] - lr
                okc = (cw[order][:-1] > 0) & (lw > 0) & (rw > 0)
                q = np.where(
                    okc, (lr * lr * rw + rr * rr * lw) / (lw * rw), -np.inf
                )
                bi = int(np.argmax(q))
                if not np.isfinite(q[bi]):
                    continue
                incl = order[: bi + 1]
                subset = np.zeros(8, np.uint32)
                for j in incl:
                    if used[j]:
                        subset[j >> 5] |= np.uint32(1) << np.uint32(j & 31)
                consider("cat", var, subset.astype(np.int32), float(q[bi]))
                continue

            cjk = np.zeros((256, K))
            np.add.at(cjk, (codes[vk], y[vk].astype(int)), w[vk])
            used = cjk.sum(1) > 0
            cats = np.nonzero(used)[0]
            mi = len(cats)
            if mi < 2:
                continue
            vecs = cjk[cats]
            if K > 2 and mi > self.params.max_categories:
                labels = cluster_categories(
                    vecs, min(self.params.max_categories, int(vk.sum()))
                )
                groups = labels
                gn = labels.max() + 1
            else:
                groups = np.arange(mi)
                gn = mi
            gk = np.zeros((gn, K))
            np.add.at(gk, groups, vecs)
            g_w = gk.sum(1)
            total = gk.sum(0)
            if K == 2:
                # 2-class: sort groups by class-1 weight, prefix scan
                # (find_split_cat_class m==2 branch)
                order = np.argsort(gk[:, 1], kind="stable")
                lc = np.cumsum(gk[order], axis=0)[:-1]
                rc = total - lc
                lw = lc.sum(1)
                rw = rc.sum(1)
                okc = (g_w[order][:-1] > 0) & (lw > 0) & (rw > 0)
                q = np.where(
                    okc,
                    (lc * lc).sum(1) / np.maximum(lw, 1e-300)
                    + (rc * rc).sum(1) / np.maximum(rw, 1e-300),
                    -np.inf,
                )
                bi = int(np.argmax(q))
                if not np.isfinite(q[bi]):
                    continue
                in_left = np.zeros(gn, bool)
                in_left[order[: bi + 1]] = True
            else:
                # exhaustive subset scan over ≤ max_categories groups
                # (Gray-code loop, o_cvdtree.cpp:633-713)
                bq, bsub = -np.inf, None
                for sub in range(1, 1 << (gn - 1)):
                    sel = np.array(
                        [(sub >> g) & 1 == 1 for g in range(gn)]
                    )
                    lc = gk[sel].sum(0)
                    rc = total - lc
                    lw, rw = lc.sum(), rc.sum()
                    if lw <= 0 or rw <= 0:
                        continue
                    q = (lc * lc).sum() / lw + (rc * rc).sum() / rw
                    if q > bq:
                        bq, bsub = q, sel
                if bsub is None:
                    continue
                q = np.array([bq])
                bi = 0
                in_left = bsub
            subset = np.zeros(8, np.uint32)
            for gi, cat in zip(groups, cats):
                if in_left[gi]:
                    subset[cat >> 5] |= np.uint32(1) << np.uint32(cat & 31)
            consider("cat", var, subset.astype(np.int32), float(np.max(q)))
        return best

    def _kernel_best_split(self, w, y, mask):
        """The split kernels over every column: the first maximum of the
        ordered columns, then a categorical one only if strictly better.
        The tables are the masked weights and weight·responses (regression)
        or the masked weights of each class (Gini); the totals are summed
        in the original sample order, as the JAX package sums them."""
        best = None
        dev = self.device
        wm = np.where(mask, w, 0.0)
        if self.regression:
            ta, tb = wm, wm * y
            total_a, total_b = tree_sum(ta), tree_sum(tb)
        else:
            cls = y.astype(np.int32)
            ta, tb = np.where(cls == 0, wm, 0.0), np.where(cls == 1, wm, 0.0)
            total_a = tree_sum(ta)
            total_b = tree_sum(wm) - total_a
        ta_d, tb_d = (torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in (ta, tb))
        if self._Xo.shape[0]:
            args = (self._vs_dev, self._so_dev, ta_d, tb_d, torch.from_numpy(mask).to(dev),
                    total_a, total_b)
            if self.regression:
                q, thr = split_scan_gather(*args)
            else:
                q, thr = split_scan_class_gather(*args, True)
            q, thr = q.cpu().numpy(), thr.cpu().numpy()
            i = int(np.argmax(q))
            if np.isfinite(q[i]):
                best = ("ord", self._ord_cols[i], np.float32(thr[i]), float(q[i]))
        if self._xc_dev is not None:
            if self.regression:
                q, subs = categorical_split(self._xc_dev, ta_d, tb_d)
            else:
                q, subs = categorical_class_split(self._xc_dev, ta_d, tb_d, True)
            q = q.cpu().numpy()
            i = int(np.argmax(q))
            if np.isfinite(q[i]) and (best is None or q[i] > best[3]):
                best = ("cat", self._cat_cols[i], subs[i].cpu().numpy(), float(q[i]))
        return best

    # ----------------------------------------------------------- pruning

    @staticmethod
    def _subtree(node):
        if node.is_leaf():
            return [node]
        return (
            DecisionTree._subtree(node.left)
            + DecisionTree._subtree(node.right)
            + [node]
        )

    def _prune(self, X, y, w, mask):
        """Cost-complexity pruning; alpha chosen by k-fold CV (+1-SE)."""
        alphas = self._alpha_sequence(self.root)
        if not alphas:
            return
        folds = self.params.cv_folds
        n = len(X)
        idx = np.nonzero(mask)[0]
        rng = np.random.default_rng(0)
        perm = rng.permutation(idx)
        fold_of = np.full(n, -1)
        for k, i in enumerate(perm):
            fold_of[i] = k % folds

        cv_err = np.zeros(len(alphas))
        cv_err2 = np.zeros(len(alphas))
        for k in range(folds):
            tr_mask = mask & (fold_of != k)
            te = mask & (fold_of == k)
            sub = DecisionTree(
                DTreeParams(
                    max_depth=self.params.max_depth,
                    min_sample_count=self.params.min_sample_count,
                    cv_folds=0,
                    regression_accuracy=self.params.regression_accuracy,
                ),
                regression=self.regression,
                categorical=self.categorical,
                device=self.device,
            )
            sub.fit(X, y, sample_weight=w, sample_idx=np.nonzero(tr_mask)[0])
            for ai, a in enumerate(alphas):
                pruned = sub._pruned_copy(sub.root, a)
                pred = sub._predict_node(pruned, X[te])
                if self.regression:
                    e = float(((pred - y[te]) ** 2).sum())
                else:
                    e = float((pred != y[te]).sum())
                cv_err[ai] += e
                cv_err2[ai] += e * e
        m = cv_err / folds
        best_ai = int(np.argmin(m))
        if self.params.use_1se_rule:
            se = np.sqrt(
                np.maximum(cv_err2 / folds - m * m, 0.0) / max(folds, 1)
            )
            lim = m[best_ai] + se[best_ai]
            for ai in range(len(alphas) - 1, -1, -1):
                if m[ai] <= lim:
                    best_ai = ai
                    break
        self.root = self._pruned_copy(self.root, alphas[best_ai])

    def _alpha_sequence(self, root):
        """Weakest-link alpha breakpoints of the full tree."""
        alphas = set()

        def subtree_stats(node):
            if node.is_leaf():
                return node.risk, 1
            lr, ln = subtree_stats(node.left)
            rr, rn = subtree_stats(node.right)
            r, leaves = lr + rr, ln + rn
            if leaves > 1:
                alphas.add(max((node.risk - r) / (leaves - 1), 0.0))
            return r, leaves

        subtree_stats(root)
        out = sorted(alphas)
        return [0.0] + [a * 1.0000001 for a in out]

    def _pruned_copy(self, node, alpha):
        if node.is_leaf():
            return node

        left = self._pruned_copy(node.left, alpha)
        right = self._pruned_copy(node.right, alpha)

        def stats(nd):
            if nd.is_leaf():
                return nd.risk, 1
            lr, ln = stats(nd.left)
            rr, rn = stats(nd.right)
            return lr + rr, ln + rn

        out = _Node(
            leaf_value=node.leaf_value,
            n=node.n,
            risk=node.risk,
            var=node.var,
            thr=node.thr,
            subset=node.subset,
            left=left,
            right=right,
            surrogates=node.surrogates,
            default_left=node.default_left,
        )
        r, leaves = stats(out)
        # weakest-link: collapse when the risk saved per removed leaf
        # g(t) = (R(t) − R_subtree)/(leaves−1) does not exceed alpha
        if leaves > 1 and (node.risk - r) / (leaves - 1) <= alpha:
            return _Node(leaf_value=node.leaf_value, n=node.n, risk=node.risk)
        return out

    # ---------------------------------------------------------- predict

    def _predict_node(self, root, X):
        X = np.asarray(X, np.float32)
        out = np.empty(len(X))
        node_ids = [root] * 1  # traverse iteratively per sample batch
        idx_all = np.arange(len(X))

        def rec(node, idx):
            if node.is_leaf():
                out[idx] = node.leaf_value
                return
            v = X[idx, node.var]
            known = ~np.isnan(v)
            if node.subset is None:
                go_left = known & (v <= node.thr)
            else:
                codes = np.where(known, v, 0).astype(np.int64)
                go_left = known & (
                    (
                        (node.subset.astype(np.uint32)[codes >> 5]
                         >> (codes & 31))
                        & 1
                    )
                    != 0
                )
            if not known.all():
                # surrogate walk for missing primaries, then the default
                # branch (predict, o_cvdtree.cpp:1762-1869)
                resolved = known.copy()
                for (svar, sthr, ssub, swap) in node.surrogates:
                    sk = ~resolved & ~np.isnan(X[idx, svar])
                    if not sk.any():
                        continue
                    sv = X[idx, svar][sk]
                    if ssub is None:
                        sl = sv <= sthr
                    else:
                        codes = sv.astype(np.int64)
                        sl = (
                            (ssub.astype(np.uint32)[codes >> 5]
                             >> (codes & 31))
                            & 1
                        ) != 0
                    go_left[sk] = sl ^ swap
                    resolved |= sk
                go_left[~resolved] = node.default_left
            rec(node.left, idx[go_left])
            rec(node.right, idx[~go_left])

        rec(root, idx_all)
        return out

    def predict(self, X):
        assert self.root is not None, "tree has not been trained yet"
        return self._predict_node(self.root, X)

    def num_leaves(self):
        def cnt(nd):
            return 1 if nd.is_leaf() else cnt(nd.left) + cnt(nd.right)

        return cnt(self.root)
