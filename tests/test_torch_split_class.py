"""The two-class split kernel (csrc/split_class.cu) on the CPU through a
numpy replay of its walk: the compact class table, a lane's two passes
over its block of 16 (the table entries and block sums, then the forward
walk with one pending kept position), the exchange of the block totals,
the chunk's last kept position carried to the next chunk that holds one,
the scan of the chunk totals, each lane's first maximum and their merge;
bit for bit against the plain version (train/split.py::
split_scan_class_ref, held against the JAX package's
_ordered_class_split_block in test_torch_train_boost_types.py) for both
qualities, at sample counts around the kernel's blocks, chunks and levels,
on exact ties and on utils/edges.py's cases. The compact table against
the two tables it replaces, and the trainers' tables against its contract.
Cuda-marked: the kernel against its plain version on the card at the same
edges, in both layouts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import BOOST_DAB, BOOST_RAB  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import haar_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.train import boost, dtree, split  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator  # noqa: E402
from cascadeclassifier_tpu_torch.utils import edges  # noqa: E402

from .test_torch_train_split import TIE_CASES, _block, _tie_block, _UpperScan  # noqa: E402
from .test_torch_train_stage import _samples  # noqa: E402

BASE, CHUNK = 16, 256  # csrc/split_class.cu: kBase, kChunk
TWO_EPS = np.float32(2 * np.float32(1.1920929e-07))
INF32 = np.float32(np.inf)


def _take(best, cand):
    """The kernel's take(): the higher quality, the lower position on a tie."""
    return cand if cand[0] > best[0] or (cand[0] == best[0] and cand[1] < best[1]) else best


KBELOW = 1.0 - 2.0**-50  # csrc/split_class.cu: kBelow


def _quality_terms(c0, c1, t0, t1, gini, n):
    """judge()'s quality at a lane's valid positions, in f64 (Gini's fmas
    emulated) → (numerators, denominators): the misclassification
    max(c0 + r1, c1 + r0) over 1; Gini's contracted numerator over tl·tr,
    NaN where a side has no weight."""
    c0, c1 = np.array(c0), np.array(c1)
    r0, r1 = t0 - c0, t1 - c1
    if not gini:
        return np.maximum(c0 + r1, c1 + r0), np.ones_like(c0)
    tl, tr = c0 + c1, r0 + r1
    t = {k: torch.from_numpy(x) for k, x in (("c0", c0), ("c1", c1), ("r0", r0), ("r1", r1),
                                             ("tl", tl), ("tr", tr))}
    left = (split.fma(t["c1"], t["c1"], t["c0"] * t["c0"]) if split.gini_l1_first(n)
            else split.fma(t["c0"], t["c0"], t["c1"] * t["c1"]))
    num = split.fma(left, t["tr"], split.fma(t["r0"], t["r0"], t["r1"] * t["r1"]) * t["tl"])
    return np.where((tl > 0) & (tr > 0), num.numpy(), np.nan), tl * tr


def _class_walk_in_numpy(vs, order, w0, w1, mask, t0, t1, gini):
    """csrc/split_class.cu step for step, one feature at a time. vs, order
    (N, B) numpy; w0, w1, mask (N,) in sample order → (q (B,), thr (B,))."""
    n, b = vs.shape
    levels = split.scan_levels(n)
    nch = -(-n // CHUNK)
    table = np.where(mask, np.where(w1 != 0, -w1, w0), np.nan)  # entry()
    qs, thrs = np.empty(b), np.empty(b, np.float32)
    for f in range(b):
        ent = np.full(nch * CHUNK, np.nan)
        ent[:n] = table[order[:, f]]
        val = np.zeros(nch * CHUNK, np.float32)
        val[:n] = vs[:, f]
        c1p, e2 = [0.0, 0.0], [0.0, 0.0]
        upper = _UpperScan(levels - 2) if nch > 1 else None
        carried = None  # (c0, c1, v, position) of the last chunk's last kept
        judged = [[] for _ in range(BASE)]  # a lane's (c0, c1, v, pos, nx), in its order
        fnext = [INF32] * BASE
        for c in range(nch):
            sums, fk = [], []
            for k in range(BASE):  # pass 1: the block's sums from +0.0
                s0 = s1 = 0.0
                kept = []
                for m in range(BASE):
                    e = ent[c * CHUNK + k * BASE + m]
                    if e >= 0:
                        s0 = s0 + e
                    elif e < 0:
                        s1 = s1 - e
                    kept.append(e == e)
                sums.append((s0, s1))
                fk.append(val[c * CHUNK + k * BASE + kept.index(True)] if any(kept) else INF32)
            ex = [(0.0, 0.0)]  # the sequential sum of the block totals before each
            for k in range(BASE - 1):
                ex.append((ex[-1][0] + sums[k][0], ex[-1][1] + sums[k][1]))
            sw = (ex[-1][0] + sums[-1][0], ex[-1][1] + sums[-1][1])
            seg = [k for k in range(BASE) if fk[k] != INF32]
            if carried is not None and seg:  # lane 0 judges it
                judged[0].append((*carried, fk[seg[0]]))
            last = None
            for k in range(BASE):  # pass 2: the walk
                e0, e1 = c1p if k == 0 else (ex[k][0] + e2[0], ex[k][1] + e2[1])
                s0 = s1 = 0.0
                pend = None
                for m in range(BASE):
                    i = c * CHUNK + k * BASE + m
                    e = ent[i]
                    if e >= 0:
                        s0 = s0 + e
                    elif e < 0:
                        s1 = s1 - e
                    if e == e:
                        if pend is not None:
                            judged[k].append((*pend, val[i]))
                        pend = (s0 + e0, s1 + e1, val[i], i)
                        if i > 0:
                            fnext[k] = min(fnext[k], val[i])
                after = [j for j in seg if j > k]
                if pend is not None and after:
                    judged[k].append((*pend, fk[after[0]]))
                elif pend is not None:
                    last = pend
            if seg:
                carried = last
            if nch > 1:
                c1p = [sw[0] + e2[0], sw[1] + e2[1]]
                e2 = upper.push(sw)
        best = []
        for cands in judged:
            bt = (-np.inf, 1 << 62, np.float32(0), np.float32(0))
            apart = [x for x in cands if np.float32(x[2] + TWO_EPS) < x[4] and np.isfinite(x[4])]
            if apart:
                num, den = _quality_terms([x[0] for x in apart], [x[1] for x in apart], t0, t1,
                                          gini, n)
                for (_c0, _c1, v, pos, nx), nm, dn in zip(apart, num, den):
                    if not gini:
                        bt = _take(bt, (nm, pos, v, nx))
                    elif nm == nm and not nm < (bt[0] * KBELOW) * dn:  # the division bound
                        bt = _take(bt, (nm / dn, pos, v, nx))
            best.append(bt)
        for off in (8, 4, 2, 1):
            best = [_take(best[t], best[t ^ off]) for t in range(BASE)]
            fnext = [min(fnext[t], fnext[t ^ off]) for t in range(BASE)]
        q, _pos, bv, bn = best[0]
        if q == -np.inf:
            bv, bn = val[0], fnext[0]
        qs[f], thrs[f] = q, np.float32((bv + bn) * np.float32(0.5))
    return qs, thrs


def _class_case(v, w, cls, mask):
    """(the replay's numpy arguments, the plain version's torch ones)."""
    args = edges.class_split_inputs(v, w, cls, mask, "cpu", "resident")
    vs, order, w0, w1, mk, t0, t1 = args
    return (vs.numpy(), order.numpy(), w0.numpy(), w1.numpy(), mk.numpy(), t0, t1), args


def _assert_walk_matches_plain(v, w, cls, mask, gini):
    replay, args = _class_case(v, w, cls, mask)
    q, thr = _class_walk_in_numpy(*replay, gini)
    gq, gthr = split.split_scan_class_gather_ref(*args, gini)
    np.testing.assert_array_equal(q, gq.numpy())
    np.testing.assert_array_equal(thr, gthr.numpy())
    return q, thr


@pytest.mark.parametrize("gini", [False, True])
@pytest.mark.parametrize("b,n", [(6, 9), (5, 300), (3, 4200), (17, 16), (3, 17), (3, 256),
                                 (3, 257), (2, 4097)])
def test_class_walk_in_numpy_matches_plain(b, n, gini):
    """The walk equals the plain version at sample counts around its
    blocks, chunks and levels (4 097: a third level of the scan)."""
    v, w, resp, mask = _block(b, n, 3 * n + b + 1)
    q, _thr = _assert_walk_matches_plain(v, w, resp > 0, mask, gini)
    if n >= 17:
        assert np.isfinite(q).sum() >= b - 1


@pytest.mark.parametrize("gini", [False, True])
@pytest.mark.parametrize("b,n,npos,span,masked", TIE_CASES)
def test_class_walk_in_numpy_first_maximum_on_exact_ties(b, n, npos, span, masked, gini):
    """Exact quality ties over a span of zero-weight samples across blocks
    and chunks: the first tied position wins; a masked span carries the
    last kept position before it over whole blocks and a chunk."""
    v, w, resp, mask = _tie_block(b, n, npos, span, n + span, masked)
    _q, thr = _assert_walk_matches_plain(v, w, resp > 0, mask, gini)
    nxt = npos + span if masked else npos
    feat = np.arange(b, dtype=np.float32)
    want = ((np.float32(npos - 1) * np.float32(0.25) + feat)
            + (np.float32(nxt) * np.float32(0.25) + feat)) * np.float32(0.5)
    np.testing.assert_array_equal(thr, want)


EDGE_LABELS = [c[0] for c in edges.class_split_edge_cases(2048)]


@pytest.mark.parametrize("gini", [False, True])
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_class_walk_in_numpy_edge_cases(label, gini):
    """utils/edges.py's cases (the table crossover of a card that keeps
    2 048 samples' tables in shared memory): n of 1, 15 and 16, one class,
    every sample masked, equal values, ±0.0, a masked chunk, ties."""
    case = next(c for c in edges.class_split_edge_cases(2048) if c[0] == label)
    _assert_walk_matches_plain(*case[1:], gini)


def _compact_table(w0, w1, mask):
    """The kernel's per-sample table (entry()): the class-0 weight, minus
    the class-1 weight where that is non-zero, NaN where mask is False."""
    return torch.where(mask, torch.where(w1 != 0, -w1, w0), float("nan"))


def _class_weights(table):
    """(w0, w1) as the kernel adds them from _compact_table's entries: an
    entry >= 0 to the class-0 sum, one < 0 negated to the class-1 sum, NaN
    to neither."""
    return torch.where(table >= 0, table, 0.0), torch.where(table < 0, -table, 0.0)


@pytest.mark.parametrize("gini", [False, True])
@pytest.mark.parametrize("b,n,mask_frac", [(9, 40, 0.0), (64, 257, 0.3), (40, 2000, 1.0)])
def test_compact_table_gives_the_two_tables_bits(b, n, mask_frac, gini):
    """The kernel's one f64 a sample (the weight signed by its class, NaN
    where masked out) carries the same sums as the two class tables: the
    plain version on the weights it adds equals the plain version on w0,
    w1."""
    v, w, resp, mask = _block(b, n, 7 * n + b, mask_frac)
    vs, order, w0, w1, mk, t0, t1 = edges.class_split_inputs(v, w, resp > 0, mask, "cpu",
                                                             "fresh")
    table = _compact_table(w0, w1, mk)
    assert torch.isnan(table).eq(~mk).all()
    a0, a1 = _class_weights(table)
    assert torch.equal(a0, w0) and torch.equal(a1, w1)
    assert (a0.view(torch.int64) == w0.view(torch.int64)).all()
    want = split.split_scan_class_gather_ref(vs, order, w0, w1, mk, t0, t1, gini)
    got = split.split_scan_class_gather_ref(vs, order, a0, a1, mk, t0, t1, gini)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def _assert_contract(w0, w1, mask):
    w0, w1, mask = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in (w0, w1, mask))
    assert ((w0 == 0) | (w1 == 0)).all()  # at most one non-zero a sample
    assert (w0[~mask] == 0).all() and (w1[~mask] == 0).all()
    assert (w0 >= 0).all() and (w1 >= 0).all()


@pytest.mark.parametrize("boost_type", [BOOST_DAB, BOOST_RAB])
def test_trainer_class_tables_hold_the_compact_table_contract(monkeypatch, boost_type):
    """Every table a DAB or RAB stage (and the CART) hands the two-class
    split holds the kernel's contract: at most one of w0, w1 non-zero a
    sample, both zero where the mask is False."""
    samples, labels, valid = _samples()
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), block_size=2048, device="cpu")
    ev.set_samples(samples)
    calls = []
    real = boost.split_scan_class_gather

    def spy(vs, order, w0, w1, mask, *rest, **kw):
        calls.append((w0, w1, mask))
        return real(vs, order, w0, w1, mask, *rest, **kw)

    monkeypatch.setattr(boost, "split_scan_class_gather", spy)
    boost.StageTrainer(ev, boost.BoostParams(boost_type=boost_type, weak_count=3)).train(
        labels, valid=valid, verbose=False)
    assert calls
    for w0, w1, mask in calls:
        _assert_contract(w0, w1, mask)
    monkeypatch.setattr(dtree, "split_scan_class_gather", spy)
    calls.clear()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.normal(size=300) > 0).astype(np.float32)
    dtree.DecisionTree(dtree.DTreeParams(cv_folds=0), device="cpu").fit(x, y)
    assert calls
    for w0, w1, mask in calls:
        _assert_contract(w0, w1, mask)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_split_scan_class_kernel_edge_cases(cuda_device):
    """utils/edges.py's cases at this card's table crossover, both
    policies and both layouts, bit for bit against the plain version on the
    CPU, with one launch a call."""
    before = _build.LAUNCHES["split_scan_class_gather"]
    n_cases, bad = edges.class_split_edge_mismatches(cuda_device)
    assert not bad
    assert _build.LAUNCHES["split_scan_class_gather"] == before + n_cases


@pytest.mark.cuda
@pytest.mark.parametrize("gini", [False, True])
def test_split_scan_class_kernel_matches_the_walk(cuda_device, gini):
    """The kernel against the numpy replay of its walk on a block of
    sample counts around its chunks."""
    v, w, resp, mask = _block(33, 600, 91)
    replay, _ = _class_case(v, w, resp > 0, mask)
    want = _class_walk_in_numpy(*replay, gini)
    got = split.split_scan_class_gather(
        *edges.class_split_inputs(v, w, resp > 0, mask, cuda_device, "fresh"), gini)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1])
