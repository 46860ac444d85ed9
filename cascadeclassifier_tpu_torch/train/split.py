"""Best stump split per feature over a sorted block (kernel 7).

Counterpart of ``cascadeclassifier_tpu/train/boost.py::
_ordered_split_block`` after its value sort (``split_scan_gather``) and of
``_ordered_split_sorted`` (``split_scan``), both XLA with no Pallas
kernel: for every feature of a block, the weighted regression split of
find_split_ord_reg (o_cvboostree.cpp:361-426) — the f64 prefix sums of the
sorted weights and weight·responses, the next kept value after each
position, validity (kept, values apart by more than 2·FLT_EPSILON, both
sides weighted), the quality (lr²·rw + rr²·lw)/(lw·rw), its first maximum
and the f32 midpoint threshold. ``split_scan_class_gather`` is the
two-class split of DAB and RAB (``_ordered_class_split_sorted``,
find_split_ord_class in o_cvboostree.cpp): the same scans of the
masked class-0 and class-1 weights, the misclassification or the Gini
quality. A CUDA tensor runs ``csrc/split_scan.cu`` (regression) or
``csrc/split_class.cu`` (two-class); a CPU tensor, or ``impl="ref"``, runs
the plain version.

Blocks are (N, B): element (i, f) is feature f's i-th sample in that
feature's sort order. ``split_scan_gather`` takes the sorted values and
the sort order in any strides (a resident block's contiguous (N, B), or
the transposed view of ``torch.sort``'s (B, N) outputs) and the
per-sample tables (masked weights, masked weight·responses, the mask),
which the kernel gathers itself; ``split_scan`` takes the gathered (N, B)
arrays, contiguous.

The f64 sums are the point. The first argmax across 162 336 features
picks a different feature when a quality moves in its last bit, so the
order of the adds is part of the arithmetic being replicated, and the
JAX package's is XLA:CPU's: ``jnp.cumsum`` is rewritten
(ReduceWindowRewriter, base 16) into sequential sums within blocks of 16
plus the blocks' own prefix, recursively; ``jnp.sum`` is rewritten
(TreeReductionRewriter) into sequential sums over windows of 32 centred on
the zero-padded row, recursively. ``scan_cumsum`` and ``tree_sum`` are
those orders. Each is a chain of IEEE adds, so it is the same on the host
and on the card, and the kernel keeps it: its blocks of 16 run in
parallel, one thread each, and the upper levels are carried per feature.
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build

SCAN_BASE = 16  # XLA:CPU ReduceWindowRewriter base length (jnp.cumsum)
SUM_WINDOW = 32  # XLA:CPU TreeReductionRewriter window (jnp.sum)
FLT_EPSILON = np.float32(1.1920929e-07)
TWO_FLT_EPSILON = float(2 * FLT_EPSILON)  # 2^-22, added in f32


def scan_levels(n: int) -> int:
    """Block levels of the scan over n samples (0: one sequential run)."""
    levels = 0
    while n > SCAN_BASE:
        n = -(-n // SCAN_BASE)
        levels += 1
    return levels


def scan_cumsum(x):
    """Inclusive prefix sums along dim 0 in XLA:CPU's order for
    ``jnp.cumsum``: for n ≤ 16 one sequential run from 0.0; otherwise
    sequential runs within blocks of 16, each plus the exclusive prefix
    of the block totals (the same scan, one level up)."""
    n = x.shape[0]
    if n <= SCAN_BASE:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[0])
        for i in range(n):
            acc = acc + x[i]
            out[i] = acc
        return out
    nb = -(-n // SCAN_BASE)
    if n % SCAN_BASE:
        xp = x.new_zeros((nb * SCAN_BASE,) + tuple(x.shape[1:]))
        xp[:n] = x
    else:
        xp = x.contiguous()
    blocks = xp.view((nb, SCAN_BASE) + tuple(x.shape[1:]))
    inner = torch.empty_like(blocks)
    acc = torch.zeros_like(blocks[:, 0])
    for j in range(SCAN_BASE):
        acc = acc + blocks[:, j]
        inner[:, j] = acc
    pref = scan_cumsum(inner[:, SCAN_BASE - 1])
    inner[1:] += pref[:-1, None]
    inner[:1] += 0.0  # block 0 adds a zero prefix, as XLA does
    return inner.reshape(xp.shape)[:n]


def tree_sum(x) -> float:
    """Sum of a 1-D f64 array in XLA:CPU's order for ``jnp.sum``: while
    longer than 32, zero-pad to a multiple of 32 (half the padding in
    front) and sum each window of 32 sequentially; then one sequential
    run over what is left."""
    a = np.asarray(x, np.float64)
    while a.shape[0] > SUM_WINDOW:
        n = a.shape[0]
        padded = -(-n // SUM_WINDOW) * SUM_WINDOW
        lo = (padded - n) // 2
        p = np.zeros(padded)
        p[lo : lo + n] = a
        blocks = p.reshape(-1, SUM_WINDOW)
        acc = np.zeros(blocks.shape[0])
        for j in range(SUM_WINDOW):
            acc = acc + blocks[:, j]
        a = acc
    acc = 0.0
    for v in a:
        acc = acc + float(v)
    return acc


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a·b = p + e exactly (Dekker's product with Veltkamp's split)."""
    p = a * b
    ca, cb = 134217729.0 * a, 134217729.0 * b  # 2^27 + 1
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a, b, c):
    """Correctly rounded a·b + c for f64 tensors without an FMA unit:
    Boldo and Melquiond's emulation (exact product, exact sum, the low
    parts added with rounding to odd, one final rounding)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(v.dtype)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def quality(lw, lr, rw, rr, n: int):
    """(lr²·rw + rr²·lw)/(lw·rw) as XLA:CPU evaluates it in the JAX
    package for a scan over n samples: LLVM contracts the sum into one
    fma, of rr·rr·lw when the scan is rewritten into blocks (n > 16) and of
    lr·lr·rw when it is one sequential run (n ≤ 16)."""
    if n > SCAN_BASE:
        return fma(rr * rr, lw, lr * lr * rw) / (lw * rw)
    return fma(lr * lr, rw, rr * rr * lw) / (lw * rw)


def next_kept(vs, kept):
    """Per position, the smallest kept value after it (+inf if none): the
    next kept value, the columns being sorted."""
    inf = torch.tensor(float("inf"), dtype=vs.dtype, device=vs.device)
    vk = torch.where(kept, vs, inf)
    out = torch.empty_like(vk)
    acc = inf.expand(vs.shape[1])
    for i in range(vs.shape[0] - 1, -1, -1):
        out[i] = acc
        acc = torch.minimum(acc, vk[i])
    return out


def _near_max_exact(ok, plain, exact):
    """The quality at the valid positions: plain (B, N) rounds each product
    on its own, exact(sel) evaluates the positions sel as the JAX package
    does (with its fmas). A numerator of terms >= 0 puts the two within a
    few ulps, so only positions within 1e-12 of a column's plain maximum
    can hold its maximum, and only they take the (costly) exact
    evaluation."""
    qual0 = plain.masked_fill_(~ok, float("-inf"))
    bq0 = qual0.max(dim=0).values
    cand = ok & (qual0 >= bq0 - 1e-12 * bq0.abs())
    qual = torch.full_like(qual0, float("-inf"))
    qual[cand] = exact(cand)
    return qual


def _first_max_threshold(qual, vs, nxt):
    """(the first maximum of each column of qual, the f32 midpoint between
    its position's value and the next kept value)."""
    n = vs.shape[0]
    bq = qual.max(dim=0).values
    posn = torch.arange(n, device=vs.device)[:, None]
    best = torch.where(qual == bq[None], posn, n).min(dim=0).values.clamp(max=n - 1)
    bv = vs.gather(0, best[None])[0]
    bn = nxt.gather(0, best[None])[0]
    return bq, (bv + bn) * np.float32(0.5)


def split_scan_ref(vs, ws, rs, kept, total_w: float, total_r: float):
    """Plain version. vs (N, B) f32 ascending down each column; ws, rs
    (N, B) f64 masked weights and weight·responses in that order; kept
    (N, B) bool; total_w, total_r summed in the original sample order →
    (quality (B,) f64, −inf where no split; threshold (B,) f32)."""
    n = vs.shape[0]
    lw = scan_cumsum(ws)
    lr = scan_cumsum(rs)
    rw = total_w - lw
    rr = total_r - lr
    nxt = next_kept(vs, kept)
    ok = kept & (vs + TWO_FLT_EPSILON < nxt) & torch.isfinite(nxt) & (lw > 0) & (rw > 0)
    plain = lr * lr
    plain.mul_(rw).add_((rr * rr).mul_(lw)).div_(lw * rw)
    qual = _near_max_exact(ok, plain, lambda c: quality(lw[c], lr[c], rw[c], rr[c], n))
    return _first_max_threshold(qual, vs, nxt)


def gini(l0, l1, r0, r1, l1_first: bool = False):
    """The Gini quality ((l0² + l1²)·rw + (r0² + r1²)·lw) / (lw·rw) of a
    two-class split, as LLVM contracts it in the JAX package:
    fma(L, rw, fma(r0, r0, r1²)·lw) / (lw·rw), where L is fma(l0, l0, l1²),
    or fma(l1, l1, l0²) when l1_first (gini_l1_first)."""
    lw, rw = l0 + l1, r0 + r1
    left = fma(l1, l1, l0 * l0) if l1_first else fma(l0, l0, l1 * l1)
    return fma(left, rw, fma(r0, r0, r1 * r1) * lw) / (lw * rw)


def gini_l1_first(n: int) -> bool:
    """Whether LLVM takes l1 first in the Gini quality of the JAX package's
    ordered two-class split over n samples: when n > 256 and n is not a
    multiple of 16 (found by holding every contraction against the
    program on the CPU for n from 9 to 4112; the trainer pads n to a
    multiple of 256). Below 9 samples the JAX package's two programs
    (_ordered_class_split_sorted alone and inside _block_split_fast)
    contract it differently from each other, and no rule is kept."""
    return n > SCAN_BASE * SCAN_BASE and n % SCAN_BASE != 0


def split_scan_class_ref(vs, w0s, w1s, kept, t0: float, t1: float, use_gini: bool):
    """Plain version of the two-class policy (the JAX package's
    _ordered_class_split_sorted: DAB with the misclassification
    criterion, RAB with Gini). vs, kept as in split_scan_ref; w0s, w1s
    (N, B) f64 the masked weights of the class-0 and the class-1 samples
    (0 elsewhere) in that order; t0, t1 their totals in the original
    sample order → (quality (B,) f64, threshold (B,) f32)."""
    n = vs.shape[0]
    c0 = scan_cumsum(w0s)
    c1 = scan_cumsum(w1s)
    r0 = t0 - c0
    r1 = t1 - c1
    nxt = next_kept(vs, kept)
    ok = kept & (vs + TWO_FLT_EPSILON < nxt) & torch.isfinite(nxt)
    if use_gini:
        lw, rw = c0 + c1, r0 + r1
        ok &= (lw > 0) & (rw > 0)
        plain = (c0 * c0 + c1 * c1).mul_(rw).add_((r0 * r0 + r1 * r1).mul_(lw)).div_(lw * rw)
        qual = _near_max_exact(ok, plain, lambda c: gini(c0[c], c1[c], r0[c], r1[c],
                                                             gini_l1_first(n)))
    else:
        qual = torch.maximum(c0 + r1, c1 + r0).masked_fill_(~ok, float("-inf"))
    return _first_max_threshold(qual, vs, nxt)


def split_scan(vs, ws, rs, kept, total_w: float, total_r: float, impl: str = "auto"):
    """Best split of every feature of a sorted (N, B) block; see
    split_scan_ref for the contract."""
    if _build.use_ref(vs, impl):
        return split_scan_ref(vs, ws, rs, kept, total_w, total_r)
    dev = vs.device
    _build.require(vs, torch.float32, 2, "vs", dev)
    _build.require(ws, torch.float64, 2, "ws", dev)
    _build.require(rs, torch.float64, 2, "rs", dev)
    _build.require(kept, torch.bool, 2, "kept", dev)
    n, b = vs.shape
    if ws.shape != vs.shape or rs.shape != vs.shape or kept.shape != vs.shape or n == 0:
        raise ValueError(f"split_scan: shapes {[tuple(t.shape) for t in (vs, ws, rs, kept)]}")
    q = torch.empty(b, dtype=torch.float64, device=dev)
    thr = torch.empty(b, dtype=torch.float32, device=dev)
    code = _build.lib().cct_split_scan(
        vs.data_ptr(), ws.data_ptr(), rs.data_ptr(), kept.data_ptr(), n, b,
        scan_levels(n), float(total_w), float(total_r), q.data_ptr(), thr.data_ptr(),
        _build.stream_of(vs),
    )
    _build.check(code, "cct_split_scan")
    _build.LAUNCHES["split_scan"] += 1
    return q, thr


def gather_inputs(order, wm, rm, mask):
    """The gathered (N, B) arrays of split_scan: the per-sample tables
    carried into each feature's sort order."""
    return wm[order], rm[order], mask[order]


def split_scan_gather_ref(vs, order, wm, rm, mask, total_w: float, total_r: float):
    """Plain version of split_scan_gather: the gather, then split_scan_ref."""
    return split_scan_ref(vs, *gather_inputs(order, wm, rm, mask), total_w, total_r)


def _launch_gather(fn: str, vs, order, ta, tb, mask, total_a: float, total_b: float, *policy):
    """Launch a gathered split kernel (fn, its C entry point; policy: the
    arguments between levels and the totals)."""
    dev = vs.device
    _build.require(vs, torch.float32, 2, "vs", dev, contiguous=False)
    _build.require(order, torch.int64, 2, "order", dev, contiguous=False)
    _build.require(ta, torch.float64, 1, "table 0", dev)
    _build.require(tb, torch.float64, 1, "table 1", dev)
    _build.require(mask, torch.bool, 1, "mask", dev)
    n, b = vs.shape
    if order.shape != vs.shape or any(t.shape != (n,) for t in (ta, tb, mask)) or n == 0:
        raise ValueError(f"{fn}: shapes {[tuple(t.shape) for t in (vs, order, ta, tb, mask)]}")
    q = torch.empty(b, dtype=torch.float64, device=dev)
    thr = torch.empty(b, dtype=torch.float32, device=dev)
    code = getattr(_build.lib(), fn)(
        vs.data_ptr(), vs.stride(0), vs.stride(1), order.data_ptr(), order.stride(0),
        order.stride(1), ta.data_ptr(), tb.data_ptr(), mask.data_ptr(), n, b, scan_levels(n),
        *policy, float(total_a), float(total_b), q.data_ptr(), thr.data_ptr(),
        _build.stream_of(vs),
    )
    _build.check(code, fn)
    return q, thr


def split_scan_gather(vs, order, wm, rm, mask, total_w: float, total_r: float,
                      impl: str = "auto"):
    """Best split of every feature of a sorted block from its sort order.

    vs (N, B) f32 ascending down each column and order (N, B) int64, the
    sample of each sorted position, in [0, N) as a sort order is, in any
    strides (``torch.sort``'s (B, N) outputs pass as their transposed
    views); wm, rm (N,) f64 the masked
    weights and weight·responses, mask (N,) bool, in sample order; totals
    as in split_scan_ref → (quality (B,) f64, threshold (B,) f32)."""
    if _build.use_ref(vs, impl):
        return split_scan_gather_ref(vs, order, wm, rm, mask, total_w, total_r)
    out = _launch_gather("cct_split_scan_gather", vs, order, wm, rm, mask, total_w, total_r)
    _build.LAUNCHES["split_scan_gather"] += 1
    return out


def class_shared_max() -> int:
    """The largest sample count whose compact table csrc/split_class.cu
    keeps in shared memory on the current device; past it the kernel reads
    the tables from global memory."""
    import ctypes

    out = ctypes.c_int()
    _build.check(_build.lib().cct_split_class_shared_max(ctypes.byref(out)),
                 "cct_split_class_shared_max")
    return out.value


def split_scan_class_gather_ref(vs, order, w0, w1, mask, t0: float, t1: float, use_gini: bool):
    """Plain version of split_scan_class_gather: the gather, then
    split_scan_class_ref."""
    return split_scan_class_ref(vs, *gather_inputs(order, w0, w1, mask), t0, t1, use_gini)


def split_scan_class_gather(vs, order, w0, w1, mask, t0: float, t1: float, use_gini: bool,
                            impl: str = "auto"):
    """Best two-class split of every feature of a sorted block from its
    sort order (DAB: misclassification, RAB: Gini): vs, order and mask as
    in split_scan_gather; w0, w1 (N,) f64 the masked weights of the
    class-0 and the class-1 samples (0 elsewhere), t0, t1 their totals in
    sample order → (quality (B,) f64, threshold (B,) f32).

    At most one of w0, w1 is non-zero per sample, and both are zero where
    mask is False (every caller forms them from one masked weight and a
    class): the kernel keeps one f64 a sample, the weight signed by its
    class, NaN where masked out (csrc/split_class.cu, entry()), and adds
    each weight to its own class's sum only, which gives the bits of the
    two sums."""
    if _build.use_ref(vs, impl):
        return split_scan_class_gather_ref(vs, order, w0, w1, mask, t0, t1, use_gini)
    out = _launch_gather("cct_split_class", vs, order, w0, w1, mask, t0, t1, int(use_gini))
    _build.LAUNCHES["split_scan_class_gather"] += 1
    return out
