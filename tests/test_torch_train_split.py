"""The split kernel's plain version (train/split.py) bit for bit against
the JAX package's split searches on the CPU (_ordered_split_sorted,
_ordered_split_block, _block_split_fast), the summation orders it copies
(XLA:CPU's jnp.cumsum and jnp.sum), the emulated fma, a numpy mirror of
the kernel's decomposition (blocks of 16 in parallel, chunks of 256, the
carried levels), the gathered form's plain version against the JAX
package, and (cuda-marked) both forms of the kernel against their plain
versions on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cascadeclassifier_tpu.train import boost as jboost  # noqa: E402
from cascadeclassifier_tpu_torch.train import split  # noqa: E402

TWO_EPS = np.float32(2 * np.float32(1.1920929e-07))


def _block(b, n, seed, mask_frac=0.2):
    """A (B, N) block with ties, neighbours within 2·FLT_EPSILON, a
    constant row (no valid split), a row with every sample masked, masked
    samples and ±1 responses."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(0, 40, (b, n)).astype(np.float32) * np.float32(0.37))
    v[:, ::7] += np.float32(1e-7)  # neighbours closer than 2·FLT_EPSILON
    # one ulp above a tie (no denormals: XLA:CPU flushes them to zero)
    v[:, 1::11] = np.nextafter(v[:, 1::11] + np.float32(0.37), np.float32(np.inf))
    v[b // 2] = 1.0  # constant row
    w = rng.random(n) ** 3
    w /= w.sum()
    resp = rng.choice([-1.0, 1.0], n)
    mask = rng.random(n) > mask_frac
    return v, w, resp, mask


def _sorted_inputs(v, w, resp, mask):
    si = np.argsort(v, axis=1, kind="stable")
    wm = np.where(mask, w, 0.0)
    rm = wm * resp
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    return (t(np.take_along_axis(v, si, 1)), t(wm[si]), t(rm[si]), t(mask[si]),
            split.tree_sum(wm), split.tree_sum(rm)), si


@pytest.mark.parametrize("n", [1, 5, 16, 17, 255, 256, 257, 3000, 4100])
def test_scan_cumsum_matches_xla_cpu_cumsum(n):
    rng = np.random.default_rng(n)
    x = rng.random((6, n)) * rng.random((6, n)) ** 8 - 0.3 * rng.random((6, n))
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(x)))
    got = split.scan_cumsum(torch.from_numpy(x.T.copy())).numpy().T
    np.testing.assert_array_equal(got, want)
    if n >= 3000:  # the order is not the sequential one
        assert (want != np.cumsum(x, axis=1)).any()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000, 3072, 9999])
def test_tree_sum_matches_xla_cpu_sum(n):
    rng = np.random.default_rng(n + 1)
    x = rng.random(n) * rng.random(n) ** 8 - 0.3 * rng.random(n)
    with jax.enable_x64(True):
        want = float(jax.jit(jnp.sum)(jnp.asarray(x)))
    assert split.tree_sum(x) == want


def test_fma_is_correctly_rounded():
    from fractions import Fraction

    rng = np.random.default_rng(1)
    n = 4000
    a = rng.random(n) * 10.0 ** rng.integers(-8, 3, n) * rng.choice([-1, 1], n)
    b = rng.random(n) * 10.0 ** rng.integers(-8, 3, n)
    c = rng.random(n) * 10.0 ** rng.integers(-12, 3, n) * rng.choice([-1, 1], n)
    c[:1000] = -(a[:1000] * b[:1000]) * (1 + rng.random(1000) * 1e-12)  # cancellation
    got = split.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,n", [(7, 5), (7, 16), (33, 17), (40, 40), (64, 300), (128, 1000),
                                 (16, 3072)])
def test_plain_matches_ordered_split_sorted(b, n):
    v, w, resp, mask = _block(b, n, b * n)
    mask[:] = True
    mask[::5] = False
    (vs, ws, rs, kept, tw, tr), _si = _sorted_inputs(v, w, resp, mask)
    ws[0, 3] = 0.0  # a zero weight inside a kept run
    with jax.enable_x64(True):
        q, thr = jboost._ordered_split_sorted(
            jnp.asarray(vs.numpy().T), jnp.asarray(ws.numpy().T), jnp.asarray(rs.numpy().T),
            jnp.asarray(kept.numpy().T), jnp.float64(tw), jnp.float64(tr))
    gq, gthr = split.split_scan_ref(vs, ws, rs, kept, tw, tr)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gthr.numpy(), np.asarray(thr))
    assert np.isinf(np.asarray(q)[b // 2]) and np.isfinite(np.asarray(q)).sum() >= b - 1


@pytest.mark.parametrize("b,n,mask_frac", [(9, 40, 0.0), (64, 257, 0.3), (40, 2000, 0.5),
                                           (8, 64, 1.0)])
def test_plain_matches_ordered_split_block(b, n, mask_frac):
    v, w, resp, mask = _block(b, n, n, mask_frac)
    (vs, ws, rs, kept, tw, tr), si = _sorted_inputs(v, w, resp, mask)
    with jax.enable_x64(True):
        q, thr = jboost._ordered_split_block(
            jnp.asarray(v), jnp.asarray(si.astype(np.int32)), jboost.as_f64(w),
            jboost.as_f64(resp), jnp.asarray(mask))
    gq, gthr = split.split_scan_ref(vs, ws, rs, kept, tw, tr)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gthr.numpy(), np.asarray(thr))
    if mask_frac == 1.0:
        assert np.isinf(np.asarray(q)).all()


@pytest.mark.parametrize("b,n,wthr", [(32, 300, -np.inf), (32, 300, 4e-4), (48, 1024, 1e-3)])
def test_plain_matches_block_split_fast(b, n, wthr):
    """The fast path's inputs (train/boost.py::fast_inputs semantics: the
    sorted validity, the trim threshold, ws · the sorted targets) and the
    plain split equal _block_split_fast's block result."""
    v, w, resp, _ = _block(b, n, 7 * n)
    valid = np.ones(n, bool)
    valid[-9:] = False  # padding
    w = np.where(valid, w, 0.0)
    si = np.argsort(v, axis=1, kind="stable")
    vs = np.take_along_axis(v, si, 1)
    ws_raw = w[si]
    kept = valid[si] & (ws_raw >= wthr)
    ws = np.where(kept, ws_raw, 0.0)
    rs = ws * resp.astype(np.float32)[si]
    mask = valid & (w >= wthr)
    wm = np.where(mask, w, 0.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    gq, gthr = split.split_scan_ref(t(vs), t(ws), t(rs), t(kept), split.tree_sum(wm),
                                    split.tree_sum(wm * resp))
    with jax.enable_x64(True):
        qm, i, thr_i = jboost._block_split_fast(
            jnp.asarray(v), jnp.asarray(vs), jnp.asarray(valid[si]),
            jnp.asarray(resp.astype(np.float32)[si]), jboost.as_f64(w), jboost.as_f64(resp),
            jnp.asarray(mask), jnp.asarray(valid), jboost.as_f64(wthr),
            classifier=False, use_gini=False, resp_static=True)
    gi = int(np.flatnonzero(gq.numpy() == gq.numpy().max())[0])
    assert gq.numpy().max() == float(qm) and gi == int(i) and gthr.numpy()[gi] == float(thr_i)


def _gather_layout(vs_bn, si_bn, layout):
    """(vs, order) as split_scan_gather takes them: a resident block's
    contiguous (N, B), or a fresh one's transposed views of torch.sort's
    (B, N) outputs."""
    if layout == "resident":
        return (torch.from_numpy(np.ascontiguousarray(vs_bn.T)),
                torch.from_numpy(np.ascontiguousarray(si_bn.T)))
    return (torch.from_numpy(np.ascontiguousarray(vs_bn)).t(),
            torch.from_numpy(np.ascontiguousarray(si_bn)).t())


def _gather_inputs(v, w, resp, mask, layout):
    """split_scan_gather's arguments for a (B, N) block, and the sort order."""
    si = np.argsort(v, axis=1, kind="stable")
    vs, order = _gather_layout(np.take_along_axis(v, si, 1), si.astype(np.int64), layout)
    wm = np.where(mask, w, 0.0)
    rm = wm * resp
    return (vs, order, torch.from_numpy(wm), torch.from_numpy(rm), torch.from_numpy(mask),
            split.tree_sum(wm), split.tree_sum(rm)), si


@pytest.mark.parametrize("layout", ["resident", "fresh"])
@pytest.mark.parametrize("b,n,mask_frac", [(9, 40, 0.0), (64, 257, 0.3), (40, 2000, 0.5),
                                           (8, 64, 1.0), (5, 16, 0.2)])
def test_gather_plain_matches_ordered_split_block(layout, b, n, mask_frac):
    v, w, resp, mask = _block(b, n, n + 11, mask_frac)
    inputs, si = _gather_inputs(v, w, resp, mask, layout)
    with jax.enable_x64(True):
        q, thr = jboost._ordered_split_block(
            jnp.asarray(v), jnp.asarray(si.astype(np.int32)), jboost.as_f64(w),
            jboost.as_f64(resp), jnp.asarray(mask))
    gq, gthr = split.split_scan_gather(*inputs)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gthr.numpy(), np.asarray(thr))


@pytest.mark.parametrize("layout", ["resident", "fresh"])
@pytest.mark.parametrize("b,n,wthr", [(32, 300, -np.inf), (32, 300, 4e-4), (48, 1024, 1e-3)])
def test_gather_plain_matches_block_split_fast(layout, b, n, wthr):
    """At a tree root (mask = valid & (w >= wthr)) the gathered form gives
    _block_split_fast's block result: its max, first index and threshold."""
    v, w, resp, _ = _block(b, n, 7 * n)
    valid = np.ones(n, bool)
    valid[-9:] = False  # padding
    w = np.where(valid, w, 0.0)
    mask = valid & (w >= wthr)
    inputs, si = _gather_inputs(v, w, resp, mask, layout)
    gq, gthr = split.split_scan_gather(*inputs)
    vs = np.take_along_axis(v, si, 1)
    with jax.enable_x64(True):
        qm, i, thr_i = jboost._block_split_fast(
            jnp.asarray(v), jnp.asarray(vs), jnp.asarray(valid[si]),
            jnp.asarray(resp.astype(np.float32)[si]), jboost.as_f64(w), jboost.as_f64(resp),
            jnp.asarray(mask), jnp.asarray(valid), jboost.as_f64(wthr),
            classifier=False, use_gini=False, resp_static=True)
    gi = int(np.flatnonzero(gq.numpy() == gq.numpy().max())[0])
    assert gq.numpy().max() == float(qm) and gi == int(i) and gthr.numpy()[gi] == float(thr_i)


def test_gather_plain_is_the_gather_then_the_array_form():
    v, w, resp, mask = _block(21, 333, 5, 0.3)
    (vs, order, wm, rm, mk, tw, tr), _si = _gather_inputs(v, w, resp, mask, "fresh")
    got = split.split_scan_gather(vs, order, wm, rm, mk, tw, tr)
    want = split.split_scan(vs.contiguous(), wm[order], rm[order], mk[order], tw, tr)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


BASE, CHUNK, TILE = 16, 256, 16  # csrc/split_scan.cu: kBase, kChunk, kTile


class _UpperScan:
    """The kernel's Scan struct with count_push: the scan of the chunk
    totals (of w and of r, one count), with `levels` block levels, fed one
    chunk total at a time → its inclusive prefix in XLA:CPU's order."""

    def __init__(self, levels):
        self.levels = levels
        self.acc = [[0.0] * (levels + 1) for _ in range(2)]
        self.ep = [[0.0] * (levels + 2) for _ in range(2)]
        self.cnt = [0] * (levels + 1)

    def push(self, xs):
        top, cnt, out = self.levels, self.cnt, []
        for a, e, x in zip(self.acc, self.ep, xs):
            a[0] = (0.0 if cnt[0] == 0 else a[0]) + x
            out.append(a[0] if top == 0 else a[0] + e[1])
            carry, t = top > 0 and cnt[0] == BASE - 1, a[0]
            for lv in range(1, top + 1):
                if not carry:
                    break
                a[lv] = (0.0 if cnt[lv] == 0 else a[lv]) + t
                e[lv] = a[lv] if lv == top else a[lv] + e[lv + 1]
                t, carry = a[lv], lv < top and cnt[lv] == BASE - 1
        for lv in range(top + 1):
            cnt[lv] += 1
            if not (lv < top and cnt[lv] == BASE):
                break
            cnt[lv] = 0
        return out


def _first_max(a, b):
    """The kernel's take(): the higher quality, the lower position on a tie."""
    return b if b[0] > a[0] or (b[0] == a[0] and b[1] < a[1]) else a


def _qualities(policy, lw, lr, tw, tr, n):
    """The kernel's quality policies at candidate positions: regression
    (lw, lr the prefixes of the weights and weight·responses), and the
    two-class misclassification and Gini qualities (lw, lr the prefixes of
    the class-0 and class-1 weights, tw, tr their totals)."""
    if policy == "reg":
        return split.quality(lw, lr, tw - lw, tr - lr, n)
    if policy == "gini":
        return split.gini(lw, lr, tw - lw, tr - lr, split.gini_l1_first(n))
    return torch.maximum(lw + (tr - lr), lr + (tw - lw))


def _kernel_in_numpy(vs, ws, rs, kept, tw, tr, policy="reg"):
    """csrc/split_scan.cu step for step: tiles of 16 features; per feature,
    chunks of 256 samples; in a chunk one thread a block of 16 (sequential
    prefixes from +0.0), the sequential sum of the block totals before it
    (the kernel's shuffles), the level-1 prefix and the scan of the chunk
    totals carried across chunks; the next kept value from the thread's
    suffix and the blocks after it, the chunk's last kept position carried
    and judged (by thread 0) against the first kept value of the next chunk
    that holds one; each thread's first maximum, merged by the kernel's
    xor pattern. policy: the quality ("reg", "misclass" or "gini"; ws, rs
    the class-0 and class-1 weights for the last two)."""
    n, b = vs.shape
    levels = split.scan_levels(n)
    inf32 = np.float32(np.inf)
    qs, thrs = np.empty(b), np.empty(b, np.float32)

    def valid(v, nx, lw, lr):
        ok = np.float32(v + TWO_EPS) < nx and np.isfinite(nx)
        if policy == "reg":
            return ok and lw > 0 and tw - lw > 0
        if policy == "gini":
            return ok and lw + lr > 0 and (tw - lw) + (tr - lr) > 0
        return ok

    for tile in range(-(-b // TILE)):
        for f in range(tile * TILE, min(b, (tile + 1) * TILE)):
            c1, e2 = [0.0, 0.0], [0.0, 0.0]
            upper = _UpperScan(levels - 2) if levels >= 2 else None
            cands = [[] for _ in range(BASE)]  # judged (pos, v, nx, lw, lr) a thread
            fnext = [inf32] * BASE
            pend, v0 = None, vs[0, f]
            for c in range(-(-n // CHUNK)):
                blk = []
                for k in range(BASE):
                    pw = pr = 0.0
                    rows = []
                    for m in range(BASE):
                        i = c * CHUNK + k * BASE + m
                        inn = i < n
                        pw += float(ws[i, f]) if inn else 0.0
                        pr += float(rs[i, f]) if inn else 0.0
                        rows.append([i, vs[i, f] if inn else np.float32(0), pw, pr,
                                     inn and bool(kept[i, f])])
                    blk.append(rows)
                tot = [(rows[-1][2], rows[-1][3]) for rows in blk]
                fk = [min([r[1] for r in rows if r[4]], default=inf32) for rows in blk]
                sw = sr = 0.0
                for k in range(BASE):
                    if levels > 0:
                        if k == 0:
                            ew, er = c1
                        elif levels == 1:
                            ew, er = sw, sr
                        else:
                            ew, er = sw + e2[0], sr + e2[1]
                        for r in blk[k]:
                            r[2], r[3] = r[2] + ew, r[3] + er
                    sw, sr = sw + tot[k][0], sr + tot[k][1]
                seg = [k for k in range(BASE) if fk[k] != inf32 or any(r[4] for r in blk[k])]
                last = None
                for k in range(BASE):
                    nx = min(fk[k + 1:], default=inf32)
                    has_next = any(j > k for j in seg)
                    for i, v, lw, lr, kp in reversed(blk[k]):
                        if not kp:
                            continue
                        if has_next:
                            if valid(v, nx, lw, lr):
                                cands[k].append((i, v, nx, lw, lr))
                        else:
                            last = (i, v, lw, lr)
                        nx, has_next = min(nx, v), True
                        if i > 0:
                            fnext[k] = min(fnext[k], v)
                if seg:
                    if pend is not None:
                        i, v, lw, lr = pend
                        cf = min(fk)
                        if valid(v, cf, lw, lr):
                            cands[0].append((i, v, cf, lw, lr))
                    pend = last
                if levels >= 2:
                    c1 = [sw + e2[0], sr + e2[1]]
                    e2 = upper.push([sw, sr])
            best = []
            for cs in cands:
                bt = (-np.inf, 1 << 62, np.float32(0), np.float32(0))
                if cs:
                    lw = torch.tensor([x[3] for x in cs], dtype=torch.float64)
                    lr = torch.tensor([x[4] for x in cs], dtype=torch.float64)
                    q = _qualities(policy, lw, lr, tw, tr, n).tolist()
                    for (i, v, nx, _lw, _lr), qq in zip(cs, q):
                        bt = _first_max(bt, (qq, i, v, nx))
                best.append(bt)
            for off in (8, 4, 2, 1):
                best = [_first_max(best[t], best[t ^ off]) for t in range(BASE)]
                fnext = [min(fnext[t], fnext[t ^ off]) for t in range(BASE)]
            q, _pos, bv, bn = best[0]
            if q == -np.inf:
                bv, bn = v0, fnext[0]
            qs[f], thrs[f] = q, np.float32((bv + bn) * np.float32(0.5))
    return qs, thrs


@pytest.mark.parametrize("b,n", [(6, 9), (5, 300), (3, 4200), (19, 1), (19, 5), (17, 16),
                                 (3, 17), (3, 255), (3, 256), (3, 257), (2, 3072), (2, 4096),
                                 (2, 4097), (1, 9999)])
def test_kernel_walk_in_numpy_matches_plain(b, n):
    """The kernel's decomposition (chunks, blocks of 16 in parallel, the
    carried levels and kept position, the merge) equals the plain version,
    at sample counts around its blocks, chunks and levels and at feature
    counts that are not a multiple of its tile."""
    v, w, resp, mask = _block(b, n, 3 * n + b)
    (vs, ws, rs, kept, tw, tr), _si = _sorted_inputs(v, w, resp, mask)
    q, thr = _kernel_in_numpy(vs.numpy(), ws.numpy(), rs.numpy(), kept.numpy(), tw, tr)
    gq, gthr = split.split_scan_ref(vs, ws, rs, kept, tw, tr)
    np.testing.assert_array_equal(q, gq.numpy())
    np.testing.assert_array_equal(thr, gthr.numpy())
    if n >= 17:
        assert np.isfinite(q).sum() >= b - 1


def _tie_block(b, n, npos, span, seed, masked=False):
    """A (B, N) block whose best split is an exact tie over a run of
    kept, zero-weight samples: per feature the positives come first in the
    sort order, then `span` samples of weight 0, then the negatives;
    distinct values and dyadic weights keep every sum exact, so each
    position from npos - 1 to npos + span - 1 has the same quality and the
    first one must win, across blocks of 16 and chunks of 256. masked: the
    span is masked out instead, so the split after position npos - 1 is
    the only best and its next kept value lies past the span."""
    rng = np.random.default_rng(seed)
    resp = np.where(np.arange(n) < npos, 1.0, -1.0)
    w = rng.integers(1, 64, n) / 1024.0
    w[npos:npos + span] = 0.0
    mask = np.ones(n, bool)
    mask[npos:npos + span] = not masked
    v = np.empty((b, n), np.float32)
    for f in range(b):
        order = np.concatenate([rng.permutation(npos), npos + rng.permutation(span),
                                npos + span + rng.permutation(n - npos - span)])
        v[f, order] = np.arange(n, dtype=np.float32) * np.float32(0.25) + f
    return v, w, resp, mask


TIE_CASES = [(3, 300, 250, 30, False), (17, 100, 10, 40, False), (2, 600, 255, 1, False),
             (2, 600, 240, 300, False), (2, 600, 256, 0, False), (2, 800, 240, 300, True)]


@pytest.mark.parametrize("b,n,npos,span,masked", TIE_CASES)
def test_kernel_walk_in_numpy_first_maximum_on_exact_ties(b, n, npos, span, masked):
    v, w, resp, mask = _tie_block(b, n, npos, span, n + span, masked)
    (vs, ws, rs, kept, tw, tr), _si = _sorted_inputs(v, w, resp, mask)
    q, thr = _kernel_in_numpy(vs.numpy(), ws.numpy(), rs.numpy(), kept.numpy(), tw, tr)
    gq, gthr = split.split_scan_ref(vs, ws, rs, kept, tw, tr)
    np.testing.assert_array_equal(q, gq.numpy())
    np.testing.assert_array_equal(thr, gthr.numpy())
    # the first tied position's threshold, not a later one's; past a masked
    # span, halfway to the first kept value after it
    nxt = npos + span if masked else npos
    feat = np.arange(b, dtype=np.float32)
    want = ((np.float32(npos - 1) * np.float32(0.25) + feat)
            + (np.float32(nxt) * np.float32(0.25) + feat)) * np.float32(0.5)
    np.testing.assert_array_equal(thr, want)


def test_scan_levels():
    assert [split.scan_levels(n) for n in (1, 16, 17, 256, 257, 3072, 4097)] == [
        0, 0, 1, 1, 2, 2, 3]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_SHAPES = [(1, 1, 0.0), (130, 17, 0.2), (257, 3072, 0.3), (64, 70000, 0.1), (33, 300, 1.0),
               (31264, 300, 0.2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,mask_frac", CUDA_SHAPES)
def test_split_scan_kernel_matches_plain(cuda_device, b, n, mask_frac):
    from cascadeclassifier_tpu_torch import _build

    v, w, resp, mask = _block(b, n, b + n, mask_frac)
    inputs, _si = _sorted_inputs(v, w, resp, mask)
    cuda = [t.to(cuda_device) for t in inputs[:4]] + list(inputs[4:])
    before = _build.LAUNCHES["split_scan"]
    q, thr = split.split_scan(*cuda)
    assert _build.LAUNCHES["split_scan"] == before + 1
    gq, gthr = split.split_scan_ref(*inputs)
    assert torch.equal(q.cpu(), gq) and torch.equal(thr.cpu(), gthr)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["resident", "fresh"])
@pytest.mark.parametrize("b,n,mask_frac", CUDA_SHAPES)
def test_split_scan_gather_kernel_matches_plain(cuda_device, layout, b, n, mask_frac):
    """Both load policies of the tables: shared memory up to a few
    thousand samples, global memory at 70 000."""
    from cascadeclassifier_tpu_torch import _build

    v, w, resp, mask = _block(b, n, b + n, mask_frac)
    inputs, _si = _gather_inputs(v, w, resp, mask, layout)
    cuda = [t.to(cuda_device) for t in inputs[:5]] + list(inputs[5:])
    if layout == "fresh" and n > 1:  # .to() keeps the transposed views' strides
        assert cuda[0].stride(0) == 1 and cuda[1].stride(0) == 1
    before = _build.LAUNCHES["split_scan_gather"]
    q, thr = split.split_scan_gather(*cuda)
    assert _build.LAUNCHES["split_scan_gather"] == before + 1
    gq, gthr = split.split_scan_gather(*inputs)
    assert torch.equal(q.cpu(), gq) and torch.equal(thr.cpu(), gthr)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,npos,span,masked", TIE_CASES)
def test_split_scan_kernels_first_maximum_on_exact_ties(cuda_device, b, n, npos, span, masked):
    v, w, resp, mask = _tie_block(b, n, npos, span, n + span, masked)
    arrays, _si = _sorted_inputs(v, w, resp, mask)
    want = split.split_scan_ref(*arrays)
    got = [split.split_scan(*[t.to(cuda_device) for t in arrays[:4]], *arrays[4:])]
    for layout in ("resident", "fresh"):
        inputs, _si = _gather_inputs(v, w, resp, mask, layout)
        got.append(split.split_scan_gather(*[t.to(cuda_device) for t in inputs[:5]],
                                           *inputs[5:]))
    for q, thr in got:
        assert torch.equal(q.cpu(), want[0]) and torch.equal(thr.cpu(), want[1])
