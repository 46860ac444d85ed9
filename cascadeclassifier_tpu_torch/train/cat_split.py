"""Best categorical split per feature of a block of LBP codes (kernel A).

Counterpart of ``cascadeclassifier_tpu/train/boost.py::
_categorical_split_block`` (find_split_cat_reg, o_cvboostree.cpp:428-516:
GAB and LB) and ``_categorical_class_split_block`` (find_split_cat_class,
o_cvboostree.cpp:249-359: DAB with the misclassification criterion, RAB
with Gini), both XLA with no Pallas kernel. For every feature of a (B, N)
block of codes in [0, 256): two f64 histograms over the 256 categories of
the per-sample tables (masked weight and masked weight·response, or the
masked weights of class 0 and of class 1), a stable ascending sort of the
categories (by mean response, or by class-1 weight), the prefix sums in
that order, the quality at each of the first 255 positions, its first
maximum, and the categories up to it as a subset of 8 words of 32 bits
(bit c & 31 of word c >> 5). A CUDA tensor runs ``csrc/cat_split.cu``
(a warp a feature: equal codes of a window of 32 samples grouped by
``__match_any_sync``, each group summed in sample order); a CPU tensor,
or ``impl="ref"``, runs the plain version.

The bits follow XLA:CPU's order for the JAX package's programs, as in
train/split.py: each histogram bin is a ``jnp.sum`` of a masked row, so
its matching samples are added in the tree of windows of 32 that
``tree_sum`` describes (the zeros between them add nothing); the totals
over the 256 bins are ``tree_sum``'s too, the prefix sums
``scan_cumsum``'s (blocks of 16), and LLVM contracts each quality into
fmas: fma(rr², lw, lr²·rw) for the regression quality, and for Gini
fma(fma(l0, l0, l1²), rw, fma(r0, r0, r1²)·lw).
"""

from __future__ import annotations

import ctypes

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.train import split
from cascadeclassifier_tpu_torch.train.split import SUM_WINDOW, fma, gini, scan_cumsum

# the quality policies of cat_split.cu
POLICY_REG, POLICY_MISCLASS, POLICY_GINI = 0, 1, 2

NCAT = 256  # maxCatCount of LBP features
WORDS = NCAT // 32
FLT_EPSILON = float(split.FLT_EPSILON)
DBL_EPSILON = 2.220446049250313e-16
HIST_BYTES = 1 << 28  # the plain histograms' working set per feature chunk


def tree_sum_last(a):
    """jnp.sum along the last dim in XLA:CPU's order (split.tree_sum, on
    every row at once)."""
    while a.shape[-1] > SUM_WINDOW:
        n = a.shape[-1]
        padded = -(-n // SUM_WINDOW) * SUM_WINDOW
        lo = (padded - n) // 2
        p = a.new_zeros(a.shape[:-1] + (padded,))
        p[..., lo:lo + n] = a
        blocks = p.view(a.shape[:-1] + (padded // SUM_WINDOW, SUM_WINDOW))
        acc = torch.zeros_like(blocks[..., 0])
        for j in range(SUM_WINDOW):
            acc = acc + blocks[..., j]
        a = acc
    acc = torch.zeros_like(a[..., 0])
    for j in range(a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def histograms(codes, tables):
    """codes (B, N) int32 in [0, 256), tables (K, N) f64 → (K, B, 256): bin
    c of feature f is the sum of the tables over the samples whose code is
    c, in jnp.sum's order over the masked row. The first level of the
    tree (windows of 32, half the padding in front) is summed sample by
    sample into (window, category) bins; the window totals go on up the
    tree."""
    b, n = codes.shape
    k = tables.shape[0]
    if n > SUM_WINDOW:
        padded = -(-n // SUM_WINDOW) * SUM_WINDOW
        lo, nw = (padded - n) // 2, padded // SUM_WINDOW
    else:
        lo, nw = 0, 1
    step = max(1, HIST_BYTES // (k * nw * NCAT * 8))
    out = tables.new_empty((k, b, NCAT))
    dev = codes.device
    wins = torch.arange(nw, device=dev)
    for f0 in range(0, b, step):
        cb = codes[f0:f0 + step].long()
        fb = cb.shape[0]
        acc = tables.new_zeros((k, fb * NCAT * nw))
        feat = torch.arange(fb, device=dev)[:, None] * (NCAT * nw)
        width = SUM_WINDOW if n > SUM_WINDOW else n
        for j in range(width):
            i = wins * SUM_WINDOW + j - lo  # sample j of each window
            ok = (i >= 0) & (i < n)
            i, w = i[ok], wins[ok]
            slot = (feat + cb[:, i] * nw + w[None]).reshape(-1)  # one add a slot
            acc[:, slot] += tables[:, i].repeat(1, fb)
        out[:, f0:f0 + fb] = tree_sum_last(acc.view(k, fb, NCAT, nw))
    return out


def _subset_words(qual, order):
    """The first maximum of qual (B, 256) (position 0 when every quality is
    -inf, clamped to 255) and the categories at sorted positions up to it,
    scattered back through order as 8 int32 words."""
    b = qual.shape[0]
    dev = qual.device
    bq = qual.max(dim=1).values
    pos = torch.arange(NCAT, device=dev)
    best = torch.where(qual == bq[:, None], pos, NCAT).min(dim=1).values.clamp(max=NCAT - 1)
    incl = pos[None] <= best[:, None]
    cat_in = torch.empty_like(incl).scatter_(1, order, incl)
    bits = cat_in.view(b, WORDS, 32).long() << torch.arange(32, device=dev)
    words = bits.sum(dim=2)
    return bq, torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _cumsum_rows(x):
    """jnp.cumsum along dim 1 of a (B, 256) array (scan_cumsum's order)."""
    return scan_cumsum(x.t().contiguous()).t()


def categorical_split_ref(codes, wm, rm):
    """Plain version of the regression policy. codes (B, N) int32; wm, rm
    (N,) f64 the masked weights and weight·responses → (quality (B,) f64,
    -inf where no split; subset (B, 8) int32)."""
    cnts, sums = histograms(codes, torch.stack([wm, rm]))
    means = torch.where(cnts.abs() > DBL_EPSILON, sums / cnts, 0.0)
    order = torch.sort(means, dim=1, stable=True).indices
    cnt_s = cnts.gather(1, order)
    sum_s = (means * cnts).gather(1, order)
    lw, lr = _cumsum_rows(cnt_s), _cumsum_rows(sum_s)
    rw = tree_sum_last(cnts)[:, None] - lw
    rr = tree_sum_last(sums)[:, None] - lr
    pos = torch.arange(NCAT, device=codes.device)
    valid = (cnt_s > FLT_EPSILON) & (lw > FLT_EPSILON) & (rw > FLT_EPSILON) & (pos < NCAT - 1)
    qual = fma(rr * rr, lw, lr * lr * rw) / (lw * rw)
    return _subset_words(torch.where(valid, qual, float("-inf")), order)


def categorical_class_split_ref(codes, w0, w1, use_gini: bool):
    """Plain version of the two-class policy. codes (B, N) int32; w0, w1
    (N,) f64 the masked weights of the class-0 and class-1 samples (0
    elsewhere) → (quality (B,) f64, subset (B, 8) int32)."""
    cw0, cw1 = histograms(codes, torch.stack([w0, w1]))
    order = torch.sort(cw1, dim=1, stable=True).indices
    s0, s1 = cw0.gather(1, order), cw1.gather(1, order)
    skip = (s0 + s1) < FLT_EPSILON
    # skipped categories move no mass
    l0 = _cumsum_rows(torch.where(skip, 0.0, s0))
    l1 = _cumsum_rows(torch.where(skip, 0.0, s1))
    r0 = tree_sum_last(cw0)[:, None] - l0
    r1 = tree_sum_last(cw1)[:, None] - l1
    pos = torch.arange(NCAT, device=codes.device)
    valid = ~skip & (pos < NCAT - 1)
    if use_gini:
        qual = gini(l0, l1, r0, r1)
        valid = valid & (l0 + l1 > FLT_EPSILON) & (r0 + r1 > FLT_EPSILON)
    else:
        qual = torch.maximum(l0 + r1, l1 + r0)
    return _subset_words(torch.where(valid, qual, float("-inf")), order)


def _launch(codes, t0, t1, policy: int):
    dev = codes.device
    _build.require(codes, torch.int32, 2, "codes", dev)
    _build.require(t0, torch.float64, 1, "t0", dev)
    _build.require(t1, torch.float64, 1, "t1", dev)
    b, n = codes.shape
    if t0.shape != (n,) or t1.shape != (n,) or n == 0:
        raise ValueError("categorical split: shapes "
                         f"{[tuple(t.shape) for t in (codes, t0, t1)]}")
    q = torch.empty(b, dtype=torch.float64, device=dev)
    subset = torch.empty((b, WORDS), dtype=torch.int32, device=dev)
    code = _build.lib().cct_cat_split(codes.data_ptr(), t0.data_ptr(), t1.data_ptr(), n, b,
                                      policy, q.data_ptr(), subset.data_ptr(),
                                      _build.stream_of(codes))
    _build.check(code, "cct_cat_split")
    _build.LAUNCHES["cat_split"] += 1
    return q, subset


def wave_features(n: int) -> int:
    """The features one launch of the kernel at n samples works on at once
    on the current CUDA device (a warp each)."""
    slots = ctypes.c_int(0)
    _build.check(_build.lib().cct_cat_split_slots(n, ctypes.byref(slots)), "cct_cat_split_slots")
    return slots.value


def categorical_split(codes, wm, rm, impl: str = "auto"):
    """Best regression split of every feature of a code block (GAB, LB);
    see categorical_split_ref for the contract."""
    if _build.use_ref(codes, impl):
        return categorical_split_ref(codes, wm, rm)
    return _launch(codes, wm, rm, POLICY_REG)


def categorical_class_split(codes, w0, w1, use_gini: bool, impl: str = "auto"):
    """Best two-class split of every feature of a code block (DAB: the
    misclassification criterion, RAB: Gini); see
    categorical_class_split_ref for the contract."""
    if _build.use_ref(codes, impl):
        return categorical_class_split_ref(codes, w0, w1, use_gini)
    return _launch(codes, w0, w1, POLICY_GINI if use_gini else POLICY_MISCLASS)
