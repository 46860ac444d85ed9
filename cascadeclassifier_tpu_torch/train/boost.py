"""Boosted cascade-stage trainer (DAB, RAB, LB, GAB; trees of any depth).

Counterpart of ``cascadeclassifier_tpu/train/boost.py`` (CvCascadeBoost,
boost.cpp:166-518, with the CvBoostTree split search of
o_cvboostree.cpp): per stage, every feature's values over the samples are
evaluated block-wise (train/evaluators.py); ordered (Haar) values are
sorted with a stable sort (the tie order of equal values decides the kept
positions), categorical (LBP) codes are not. Per weak tree, the exact
weighted split of every feature comes from a split kernel and the first
maximum across blocks wins: GAB and LB grow regression stumps
(train/split.py's ordered split, train/cat_split.py's categorical one),
DAB and RAB two-class stumps with the misclassification and the Gini
criterion (set_params, o_cvboost.cpp:67-99; the two-class policies of
the same kernels). Boosting state (weights, trimming, the stage
threshold) stays numpy f64 on the host, mirroring update_weights
(boost.cpp:168-407), trim_weights (o_cvboost.cpp:101-139) and
isErrDesired (boost.cpp:479-518).

Weak trees of max_depth > 1 grow by recursive masked splits (node masks
replace the reference's index-partitioning split_node_data): the same split
kernels run under each node's mask.

On a ``FeatureMesh`` (parallel/sharded.py) every block's feature rows are
cut into shards, each on its own device (or, on a process mesh, each in
its own process): every shard sorts and splits its rows, and the best of
each block over its shards, ties to the lowest global index, goes into
the same walk over blocks. A feature's split arithmetic never crosses
rows, so a sharded stage is the unsharded stage bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from cascadeclassifier_tpu_torch.models.model import (
    BOOST_DAB,
    BOOST_GAB,
    BOOST_LB,
    BOOST_RAB,
    Stage,
    WeakTree,
)
from cascadeclassifier_tpu_torch.parallel.sharded import (
    FeatureMesh,
    first_best,
    gather_records,
    on_device,
    pad_rows,
    shard_span,
)
from cascadeclassifier_tpu_torch.train.cat_split import categorical_class_split, categorical_split
from cascadeclassifier_tpu_torch.train.split import (
    gather_inputs,
    split_scan_class_gather,
    split_scan_gather,
    tree_sum,
)
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count, span

FLT_EPSILON = np.float32(1.1920929e-07)
CV_THRESHOLD_EPS = 1e-5
LB_Z_MAX = 10.0
LB_WEIGHT_THRESH = FLT_EPSILON


def _log_ratio(p):
    eps = 1e-5
    p = min(max(p, eps), 1.0 - eps)
    return math.log(p / (1.0 - p))


def _node_value_class(w, cls, mask, boost_type):
    """Two-class leaf (calc_node_value, o_cvboostree.cpp:669-698): DAB's
    is the majority class as ±1, RAB's half the log-odds of class 1;
    numpy sums, as the JAX package takes them."""
    wm = np.where(mask, w, 0.0)
    rcw1 = float(wm[cls == 1].sum())
    rcw0 = float(wm.sum()) - rcw1
    if boost_type == BOOST_DAB:
        return 1.0 if rcw1 > rcw0 else -1.0
    p = rcw1 / (rcw0 + rcw1) if (rcw0 + rcw1) > 0 else 0.5
    return 0.5 * _log_ratio(p)


@dataclasses.dataclass
class BoostParams:
    boost_type: int = BOOST_GAB
    min_hit_rate: float = 0.995
    max_false_alarm: float = 0.5
    weight_trim_rate: float = 0.95
    max_depth: int = 1
    weak_count: int = 100
    min_sample_count: int = 10


def check_mesh(mesh):
    """Raise TypeError unless mesh is None or a FeatureMesh."""
    if mesh is not None and not isinstance(mesh, FeatureMesh):
        raise TypeError(f"mesh must be a parallel.sharded.FeatureMesh, got {type(mesh).__name__}")


class FeatureCache:
    """Per-stage feature values and sort machinery over the current
    samples (the reference's valCache / sorted-index buf,
    o_cvcascadeboosttraindata.cpp:246-273).

    ``val_buf_mb`` caps resident raw values, ``idx_buf_mb`` the resident
    sort machinery, at block granularity and with the JAX package's byte
    counts: a value block is blk·n·4 bytes, an index block blk·n·17.
    Blocks past the value budget recompute their values on every access;
    blocks past the index budget re-sort on every access.

    Sorted views are (N, B): resident blocks are stored contiguous, a
    block sorted anew is the transposed view of ``torch.sort``'s (B, N)
    outputs; the split kernel takes either by its strides. A categorical
    evaluator (LBP codes) keeps no sort machinery.

    ``mesh``: a FeatureMesh; every block's rows are held as the mesh's
    local shards (``shard_span``: ⌈B/S⌉ rows each, zero-padded), each on
    its device. In-process the block is evaluated once and its rows
    split; on a process mesh a rank evaluates its own rows only
    (``values_for_vars``). Without a mesh a block is one shard. Lists
    ``values``, ``vs`` and ``order`` hold, per block, each local shard's."""

    def __init__(self, evaluator, val_buf_mb: float | None = None,
                 idx_buf_mb: float | None = None, mesh: FeatureMesh | None = None):
        self.ev = evaluator
        self.mesh = mesh
        self.shards = [0] if mesh is None else mesh.local_shards
        self.devices = [evaluator.device] if mesh is None else mesh.devices
        nb = evaluator.num_blocks()
        n = evaluator.n
        blk = evaluator.block_size
        if val_buf_mb is None:
            self.n_val = nb
        else:
            self.n_val = min(nb, int(val_buf_mb * 2**20 // (4 * n * blk)))
        if idx_buf_mb is None:
            self.n_idx = nb
        else:
            self.n_idx = min(nb, int(idx_buf_mb * 2**20 // (17 * n * blk)))
        self.categorical = evaluator.maxCatCount > 0
        if self.categorical:
            self.n_idx = 0
        self.n_idx = min(self.n_idx, self.n_val)
        self.num_blocks = nb
        k = len(self.shards)
        self.values = [[None] * k for _ in range(nb)]  # (P, N) f32 rows, or int32 codes
        self.vs = [[None] * k for _ in range(nb)]  # (N, P) sorted values, resident blocks
        self.order = [[None] * k for _ in range(nb)]  # (N, P) stable sort order, resident
        for b in range(nb):
            if b < self.n_val:
                self.values[b] = self._evaluate(b)
            if b < self.n_idx:
                for s in range(k):
                    self.order[b][s], self.vs[b][s] = (
                        x.contiguous() for x in self.sorted_block(b, s))
        self.valid_sorted = None
        self.aux_sorted = None

    def span(self, b, k=0):
        """(global index of local shard k's first row of block b, its real
        rows); the rest of its ⌈B/S⌉ rows are padding."""
        lo, hi = self.ev.block_slice(b)
        if self.mesh is None:
            return lo, hi - lo
        first, n, _per = shard_span(hi - lo, self.mesh.size, self.shards[k])
        return lo + first, n

    def _evaluate(self, b):
        """Block b's rows of every local shard, zero-padded, on its device."""
        if self.mesh is None:
            return [self.ev.values_block(b)]
        lo, hi = self.ev.block_slice(b)
        _first, _n, per = shard_span(hi - lo, self.mesh.size, 0)
        if self.mesh.group is None:
            full = self.ev.values_block(b)
            out = []
            for k, dev in enumerate(self.devices):
                a, n = self.span(b, k)
                out.append(pad_rows(full[a - lo:a - lo + n], per).to(dev))
            return out
        a, n = self.span(b)
        if n:
            rows = self.ev.values_for_vars(np.arange(a, a + n))
        else:
            rows = torch.zeros((0, self.ev.n), dtype=torch.int32 if self.categorical
                               else torch.float32, device=self.ev.device)
        return [pad_rows(rows, per).to(self.devices[0])]

    def block_values(self, b, k=0):
        """Raw (P, N) values of local shard k of block b (without a mesh,
        the (B, N) block), resident or recomputed."""
        if self.values[b][k] is not None:
            return self.values[b][k]
        return self._evaluate(b)[k]

    def sorted_block(self, b, k=0, values=None):
        """(sort order, sorted values) of local shard k of block b (of
        ``values``, its rows, when given) by a stable sort, both (N, P);
        resident blocks keep theirs, others are views of the sort's
        outputs."""
        if self.order[b][k] is not None:
            return self.order[b][k], self.vs[b][k]
        vs, si = torch.sort(self.block_values(b, k) if values is None else values, dim=1,
                            stable=True)
        return si.t(), vs.t()

    def shard_inputs(self, b):
        """What the split kernel takes of each local shard of block b: the
        codes (categorical) or the (sort order, sorted values), resident
        or computed now (one evaluation of the block for every shard)."""
        fresh = None
        out = []
        for k in range(len(self.shards)):
            vals = self.values[b][k]
            if vals is None and (self.categorical or self.order[b][k] is None):
                if fresh is None:
                    fresh = self._evaluate(b)
                vals = fresh[k]
            out.append(vals if self.categorical else self.sorted_block(b, k, vals))
        return out

    def resident_row(self, var_idx: int):
        """The values of feature var_idx from a resident local shard, or
        None."""
        b = var_idx // self.ev.block_size
        for k in range(len(self.shards)):
            first, n = self.span(b, k)
            if first <= var_idx < first + n and self.values[b][k] is not None:
                return self.values[b][k][var_idx - first]
        return None

    def set_stage(self, valid, aux):
        """Per-stage sorted views of validity (bool) and the responses (f32:
        GAB targets are exactly ±1) for the resident blocks' shards, which
        fast_inputs reads; nothing for a categorical evaluator."""
        if self.categorical:
            return
        self.valid_sorted = [[None] * len(self.shards) for _ in range(self.num_blocks)]
        self.aux_sorted = [[None] * len(self.shards) for _ in range(self.num_blocks)]
        for k, dev in enumerate(self.devices):
            vj = torch.as_tensor(valid, device=dev)
            aj = torch.as_tensor(np.asarray(aux, np.float32), device=dev)
            for b in range(self.num_blocks):
                if self.order[b][k] is not None:
                    self.valid_sorted[b][k] = vj[self.order[b][k]]
                    self.aux_sorted[b][k] = aj[self.order[b][k]]


def fast_inputs(cache: FeatureCache, b: int, w_dev, wthr: float, k: int = 0):
    """split_scan's inputs of local shard k of a resident block at a tree
    root, where the subsample is valid & (w >= wthr) (boost.py:527
    _block_split_fast): the weights carried into each feature's order,
    kept = sorted validity & the trim threshold, rs = ws · the sorted ±1
    targets (after cache.set_stage). They equal generic_inputs' there,
    and the gathered form split_scan_gather computes the same split from
    the sort order."""
    ws_raw = w_dev[cache.order[b][k]]
    kept = cache.valid_sorted[b][k] & (ws_raw >= wthr)
    ws = torch.where(kept, ws_raw, 0.0)
    return cache.vs[b][k], ws, ws * cache.aux_sorted[b][k], kept


def generic_inputs(cache: FeatureCache, b: int, w_dev, resp_dev, mask_dev, k: int = 0):
    """split_scan's inputs of local shard k of any block under any mask
    (boost.py:129 _ordered_split_block): the sorted values, contiguous
    (N, P), and the masked weights and weight·responses gathered into the
    sort order."""
    order, vs = cache.sorted_block(b, k)
    wm = torch.where(mask_dev, w_dev, 0.0)
    return (vs.contiguous(), *gather_inputs(order, wm, wm * resp_dev, mask_dev))


def best_of_block(q):
    """(max, first index of the max) on the device."""
    qm = q.max()
    n = q.shape[0]
    idx = torch.arange(n, device=q.device)
    return qm, torch.where(q == qm, idx, n).min().clamp(max=n - 1)


class StageTrainer:
    """Trains one boosted stage; mirrors CvCascadeBoost::train
    (boost.cpp:409-459). val_buf_mb / idx_buf_mb: precalc buffer budgets
    (-precalcValBufSize / -precalcIdxBufSize). mesh: a FeatureMesh over
    whose shards every block's features are split (FeatureCache); on a
    process mesh every rank runs the same trainer, and each split search
    makes one all_gather."""

    def __init__(self, evaluator, params: BoostParams, val_buf_mb: float | None = None,
                 idx_buf_mb: float | None = None, mesh: FeatureMesh | None = None):
        check_mesh(mesh)
        self.ev = evaluator
        self.params = params
        self.val_buf_mb = val_buf_mb
        self.idx_buf_mb = idx_buf_mb
        self.mesh = mesh
        self.categorical = evaluator.maxCatCount > 0
        self.classifier = params.boost_type in (BOOST_DAB, BOOST_RAB)

    # -- weak-tree construction --------------------------------------------

    def _find_best_split(self, cache, w, resp, mask):
        """Global best split across every feature → (var_idx, threshold or
        subset) or None.

        Ordered blocks, resident or sorted anew, go to the gathered split
        kernel with their sort order and the per-sample tables (at a tree
        root mask is valid & (w >= the trim threshold), where the JAX
        package's fast path gives the same inputs); categorical blocks go
        to the categorical kernel with their codes. The tables are the
        masked weights and weight·responses (regression) or the masked
        weights of each class (DAB, RAB); the totals are summed once, in
        the original sample order (f64 summation order is part of the
        arithmetic being replicated).

        Each local shard of each block gives a record (its first maximum,
        the feature's global index, the threshold or the 8 subset words,
        all f64, exact); padding rows never win. The records come to the
        host in one fetch a device (one all_gather on a process mesh),
        and the first maximum over blocks and their shards in global
        order is the split: earlier features win ties (the ascending
        feature scan)."""
        wm = np.where(mask, w, 0.0)
        if self.classifier:
            w0, w1 = np.where(self._cls == 0, wm, 0.0), np.where(self._cls == 1, wm, 0.0)
            total_a = tree_sum(w0)
            total_b = tree_sum(wm) - total_a
            use_gini = self.params.boost_type == BOOST_RAB
        else:
            total_a, total_b = tree_sum(wm), tree_sum(wm * resp)
        tables = {}

        def tables_on(dev):
            """The per-sample tables and mask on dev, built once a search."""
            if dev not in tables:
                count(SYNC, 3)
                mask_dev = torch.as_tensor(mask, device=dev)
                if self.classifier:
                    ta, tb = torch.as_tensor(w0, device=dev), torch.as_tensor(w1, device=dev)
                else:
                    ta = torch.where(mask_dev, torch.as_tensor(w, dtype=torch.float64,
                                                               device=dev), 0.0)
                    tb = ta * torch.as_tensor(resp, dtype=torch.float64, device=dev)
                tables[dev] = ta, tb, mask_dev
            return tables[dev]

        records = [[] for _ in cache.shards]
        for b in range(cache.num_blocks):
            for k, inputs in enumerate(cache.shard_inputs(b)):
                dev = cache.devices[k]
                ta, tb, mask_dev = tables_on(dev)
                with on_device(dev):
                    if self.categorical and self.classifier:
                        q, pay = categorical_class_split(inputs, ta, tb, use_gini)
                    elif self.categorical:
                        q, pay = categorical_split(inputs, ta, tb)
                    elif self.classifier:
                        q, pay = split_scan_class_gather(inputs[1], inputs[0], ta, tb, mask_dev,
                                                         total_a, total_b, use_gini)
                    else:
                        q, pay = split_scan_gather(inputs[1], inputs[0], ta, tb, mask_dev,
                                                   total_a, total_b)
                    first, real = cache.span(b, k)
                    if real < q.shape[0]:
                        q[real:] = float("-inf")  # padding rows never win
                    qm, i = best_of_block(q)
                    count(SYNC)  # pay[i]: a 0-d device index is read on the host
                    records[k].append(torch.cat([qm.reshape(1), (first + i).double().reshape(1),
                                                 pay[i].double().reshape(-1)]))
        recs = gather_records(self.mesh, [torch.stack(r) for r in records])  # (S, blocks, K)
        best = first_best(recs.transpose(1, 0, 2).reshape(-1, recs.shape[2]))
        if not np.isfinite(best[0]):
            return None
        pay = best[2:].astype(np.int32) if self.categorical else np.float32(best[2])
        return int(best[1]), pay

    def _values_of_var(self, cache, var_idx: int) -> np.ndarray:
        """A feature's values: from the local shard that holds them when it
        is resident, else evaluated (on a process mesh, also where another
        rank holds them)."""
        row = cache.resident_row(var_idx)
        if row is None:
            row = self.ev.values_for_vars([var_idx])[0]
        count(SYNC)
        return row.cpu().numpy()

    def _node_value(self, w, resp, node_mask) -> np.float32:
        """The leaf of a node: the weighted mean response (calc_node_value,
        o_cvboostree.cpp:699-727, both sums in the original sample order),
        or the two-class leaf of DAB and RAB."""
        if self.classifier:
            return np.float32(_node_value_class(w, self._cls, node_mask, self.params.boost_type))
        wm = np.where(node_mask, w, 0.0)
        return np.float32(tree_sum(wm * resp) / tree_sum(wm))

    def _go_left(self, tree_thr, vals):
        """Per-sample branch of a node: the subset bit of each code
        (categorical) or ``val <= thr``."""
        if self.categorical:
            code = vals.astype(np.int64)
            return ((np.asarray(tree_thr, np.uint32)[code >> 5] >> (code & 31)) & 1) != 0
        return vals <= tree_thr

    def _train_tree(self, cache, w, resp, mask):
        """Grow one weak tree by recursive masked splits (boost.py:725
        ``grow`` of the JAX package) → (WeakTree, per-sample predictions),
        or (None, None) when the root cannot split. Nodes are numbered in
        pre-order, left subtree first; leaves are appended in the same walk
        and coded -(leaf index). A node becomes a leaf at max_depth, at
        min_sample_count samples or fewer, when no feature splits it, or
        when a side of its best split is empty."""
        p = self.params
        nodes, leaves = [], []  # nodes: [left, right, var, thr or subset]

        def leaf(node_mask):
            leaves.append(self._node_value(w, resp, node_mask))
            return -(len(leaves) - 1)

        def grow(node_mask, depth):
            if depth >= p.max_depth or int(node_mask.sum()) <= p.min_sample_count:
                return leaf(node_mask)
            with span("boost.split"):
                split = self._find_best_split(cache, w, resp, node_mask)
            if split is None:
                return leaf(node_mask)
            var_idx, thr = split
            go_left = self._go_left(thr, self._values_of_var(cache, var_idx))
            lmask, rmask = node_mask & go_left, node_mask & ~go_left
            if lmask.sum() == 0 or rmask.sum() == 0:
                return leaf(node_mask)
            me = len(nodes)
            nodes.append([0, 0, var_idx, thr])
            nodes[me][0] = grow(lmask, depth + 1)
            nodes[me][1] = grow(rmask, depth + 1)
            return me

        if grow(mask.copy(), 0) < 0:  # the root is a leaf: no tree
            return None, None
        tree = WeakTree(
            left=np.array([nd[0] for nd in nodes], np.int32),
            right=np.array([nd[1] for nd in nodes], np.int32),
            feature_idx=np.array([nd[2] for nd in nodes], np.int32),
            threshold=None if self.categorical else np.array([nd[3] for nd in nodes], np.float32),
            subsets=np.stack([np.asarray(nd[3], np.int32) for nd in nodes])
            if self.categorical else None,
            leaf_values=np.array(leaves, np.float32),
        )
        return tree, self._predict_tree(tree, cache, mask.shape[0])

    def _predict_tree(self, tree, cache, n):
        """Leaf value of every sample in f64 from the f32 leaves (predict,
        o_cvcascadeboosttree.cpp:16-39). Pre-order numbering puts every
        node after its parent, so one pass in node order walks the tree."""
        node = np.zeros(n, np.int64)
        out = np.zeros(n, np.float64)
        for ni in range(tree.num_nodes):
            at = node == ni
            if not at.any():
                continue
            thr = tree.subsets[ni] if self.categorical else tree.threshold[ni]
            go_left = self._go_left(thr, self._values_of_var(cache, int(tree.feature_idx[ni])))
            child = np.where(go_left, tree.left[ni], tree.right[ni])
            out = np.where(at & (child <= 0), tree.leaf_values[-np.minimum(child, 0)], out)
            node = np.where(at, np.where(child > 0, child, -1), node)
        return out

    # -- boosting loop ------------------------------------------------------

    def train(self, labels: np.ndarray, valid: np.ndarray | None = None, verbose=True):
        """labels: (N,) {0,1}; the evaluator already holds the samples.
        ``valid`` marks real samples when the batch is padded (padding has
        zero weight and enters no statistic). → (Stage, per-sample sums),
        or (None, None) if no tree trained."""
        p = self.params
        n = labels.shape[0]
        if valid is None:
            valid = np.ones(n, bool)
        n_real = int(valid.sum())
        self._valid = valid
        self._cls = labels.astype(np.int32)
        t0 = time.time()
        with span("boost.precalc"):
            cache = FeatureCache(self.ev, val_buf_mb=self.val_buf_mb,
                                 idx_buf_mb=self.idx_buf_mb, mesh=self.mesh)
        if verbose:
            print(f"Precalculation time: {int(time.time() - t0)}")

        orig = labels.astype(np.int32) * 2 - 1  # {−1, +1}
        w = np.where(valid, 1.0 / n_real, 0.0)
        mask = valid.copy()
        if p.boost_type == BOOST_LB:
            sum_response = np.zeros(n, np.float64)
            resp = np.where(orig > 0, 2.0, -2.0)
        else:  # ±1 targets (DAB and RAB split on the classes)
            resp = orig.astype(np.float64)

        trees = []
        stage_sums = np.zeros(n, np.float64)
        threshold = 0.0
        num_pos = int(((labels == 1) & valid).sum())
        num_neg = n_real - num_pos

        if verbose:
            print("+----+---------+---------+")
            print("|  N |    HR   |    FA   |")
            print("+----+---------+---------+")

        while True:
            with span("boost.tree"):
                tree, preds = self._train_tree(cache, w, resp, mask)
                if tree is None:
                    break
                # update_weights (boost.cpp:267-407)
                if p.boost_type == BOOST_DAB:
                    # boost.cpp:284-317: err = Σw·(f≠y)/Σw, C = −logRatio(err),
                    # w *= exp(C) where wrong, then the tree is scaled by C
                    sw = w.sum()
                    wrong = preds != orig
                    err = float(np.sum(w * wrong)) / max(sw, 1e-300)
                    c = -_log_ratio(err)
                    w = w * np.where(wrong, math.exp(c), 1.0)
                    tree.leaf_values = (tree.leaf_values * np.float32(c)).astype(np.float32)
                    preds = preds * c
                elif p.boost_type == BOOST_LB:
                    sum_response = sum_response + 0.5 * preds
                    prob = 1.0 / (1.0 + np.exp(-2.0 * sum_response))
                    w = np.maximum(prob * (1.0 - prob), float(LB_WEIGHT_THRESH))
                    resp = np.where(orig > 0,
                                    np.minimum(1.0 / np.maximum(prob, 1e-300), LB_Z_MAX),
                                    -np.minimum(1.0 / np.maximum(1.0 - prob, 1e-300), LB_Z_MAX))
                else:  # GAB and RAB
                    w = w * np.exp(-orig * preds)
                sw = w.sum()
                if sw > float(FLT_EPSILON):
                    w = w / sw
                # trim_weights (o_cvboost.cpp:101-139): padding has weight 0 and
                # consumes no trim budget
                if 0.0 < p.weight_trim_rate < 1.0:
                    ws = np.sort(w[valid])
                    csum = np.concatenate([[0.0], np.cumsum(ws)])
                    i = int(np.searchsorted(csum[1:], 1.0 - p.weight_trim_rate))
                    thr_w = ws[i] if i < n_real else np.inf
                    mask = valid & (w >= thr_w)
                trees.append(tree)
                stage_sums = stage_sums + preds

                # isErrDesired (boost.cpp:479-518)
                pos_sums = np.sort(stage_sums[(labels == 1) & valid])
                t_idx = int((1.0 - p.min_hit_rate) * num_pos)
                threshold = float(pos_sums[t_idx])
                num_pos_true = num_pos - t_idx
                for i in range(t_idx - 1, -1, -1):
                    if abs(pos_sums[i] - threshold) < float(FLT_EPSILON):
                        num_pos_true += 1
                hit_rate = num_pos_true / max(num_pos, 1)
                neg_sums = stage_sums[(labels == 0) & valid]
                accepted = neg_sums >= threshold - CV_THRESHOLD_EPS
                false_alarm = float(accepted.sum()) / num_neg if num_neg else 0.0
                if verbose:
                    print(f"|{len(trees):>4}|{hit_rate:>9.6g}|{false_alarm:>9.6g}|")
                    print("+----+---------+---------+")

                if not mask.any():
                    break
                if false_alarm <= p.max_false_alarm:
                    break
                if len(trees) >= p.weak_count:
                    break

        if not trees:
            return None, None
        return Stage(threshold=threshold, trees=trees), stage_sums
