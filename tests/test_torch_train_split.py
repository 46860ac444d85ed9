"""The split kernel's plain version (train/split.py) bit for bit against
the JAX package's split searches on the CPU (_ordered_split_sorted,
_ordered_split_block, _block_split_fast), the summation orders it copies
(XLA:CPU's jnp.cumsum and jnp.sum), the emulated fma, a numpy mirror of
the kernel's one-thread-per-feature walk, and (cuda-marked) the kernel
against the plain version on the card."""

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


def _kernel_in_numpy(vs, ws, rs, kept, tw, tr):
    """csrc/split_scan.cu step for step: per feature one walk in sample
    order carrying the block sums of each scan level; a kept position is
    judged when the next kept one is reached."""
    n, b = vs.shape
    levels = split.scan_levels(n)
    qs, thrs = np.empty(b), np.empty(b, np.float32)
    for f in range(b):
        acc = {k: [0.0] * (levels + 1) for k in "wr"}
        ep = {k: [0.0] * (levels + 2) for k in "wr"}
        cnt = [0] * (levels + 1)

        def push(key, x):
            a, e = acc[key], ep[key]
            a[0] = (0.0 if cnt[0] == 0 else a[0]) + x
            p = a[0] if levels == 0 else a[0] + e[1]
            carry, t = levels > 0 and cnt[0] == 15, a[0]
            for lv in range(1, levels + 1):
                if not carry:
                    break
                a[lv] = (0.0 if cnt[lv] == 0 else a[lv]) + t
                e[lv] = a[lv] if lv == levels else a[lv] + e[lv + 1]
                t, carry = a[lv], lv < levels and cnt[lv] == 15
            return p

        best_q, best_v, best_n = -np.inf, np.float32(0), np.float32(0)
        first_next, prev = np.float32(np.inf), None
        for i in range(n):
            lw, lr = push("w", float(ws[i, f])), push("r", float(rs[i, f]))
            for lv in range(levels + 1):  # count_push
                cnt[lv] += 1
                if not (lv < levels and cnt[lv] == 16):
                    break
                cnt[lv] = 0
            if not kept[i, f]:
                continue
            v = vs[i, f]
            if i > 0 and first_next == np.inf:
                first_next = v
            if prev is not None:
                pv, plw, plr = prev
                rw, rr = tw - plw, tr - plr
                if np.float32(pv + TWO_EPS) < v and plw > 0 and rw > 0:
                    q = split.quality(*(torch.tensor([x], dtype=torch.float64)
                                        for x in (plw, plr, rw, rr)), n)[0].item()
                    if q > best_q:
                        best_q, best_v, best_n = q, pv, v
            prev = (v, lw, lr)
        if best_q == -np.inf:
            best_v, best_n = vs[0, f], first_next
        qs[f], thrs[f] = best_q, np.float32((best_v + best_n) * np.float32(0.5))
    return qs, thrs


@pytest.mark.parametrize("b,n", [(6, 9), (5, 300), (3, 4200)])
def test_kernel_walk_in_numpy_matches_plain(b, n):
    v, w, resp, mask = _block(b, n, 3 * n + b)
    (vs, ws, rs, kept, tw, tr), _si = _sorted_inputs(v, w, resp, mask)
    q, thr = _kernel_in_numpy(vs.numpy(), ws.numpy(), rs.numpy(), kept.numpy(), tw, tr)
    gq, gthr = split.split_scan_ref(vs, ws, rs, kept, tw, tr)
    np.testing.assert_array_equal(q, gq.numpy())
    np.testing.assert_array_equal(thr, gthr.numpy())


def test_scan_levels():
    assert [split.scan_levels(n) for n in (1, 16, 17, 256, 257, 3072, 4097)] == [
        0, 0, 1, 1, 2, 2, 3]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,mask_frac", [(1, 1, 0.0), (130, 17, 0.2), (257, 3072, 0.3),
                                           (64, 70000, 0.1), (33, 300, 1.0)])
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
