"""The dense miner (train/mine.py, csrc/mine.cu) against the JAX package's
dense mining program on the CPU.

- ``mine_ref`` and the port's ``predict_levels`` built on it give the
  masks of the JAX package's ``CascadePredictor.predict_levels``
  (``_dense_chunk_fn``) on lazy and eager levels, partial first rows, a
  level of one window and an empty one, for Haar BASIC at 12x12 and
  24x24, Haar ALL with tilted features and LBP, with stage sets of 1 to
  300 trees (stages_from_jax of JAX stages).
- ``_mine_kernel_in_numpy`` replays ``csrc/mine.cu`` step for step (the
  pixels from the axis tables, the integral a column sum and a warp scan
  at a time, the tilted recurrence, the norm factor, the features, the
  streaming blocked prefix and the early exit) and gives the same masks
  on the same cases and on utils/edges.py's miner edges; its streaming
  prefix equals ``scan_cumsum`` bit for bit past every block boundary.
- ``pack_levels`` covers exactly the positions it was given, in order,
  and its source arena starts over past its cap; ``check_exact`` fires
  beyond 2^24, in the kernel's wrapper only.
- ``tests/test_torch_mine_cuda.py`` holds ``mine`` against ``mine_ref``
  on the card.

Masks are compared for equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.data.negreader import LazyLevel as JLazyLevel  # noqa: E402
from cascadeclassifier_tpu.models.model import Stage as JStage  # noqa: E402
from cascadeclassifier_tpu.models.model import WeakTree as JWeakTree  # noqa: E402
from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    LBPTrainEvaluator as JLBPTrainEvaluator,
)
from cascadeclassifier_tpu.train.predictor import CascadePredictor as JPredictor  # noqa: E402
from cascadeclassifier_tpu_torch.convert import stages_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.data.negreader import LazyLevel  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import haar_catalog, sum_offsets  # noqa: E402
from cascadeclassifier_tpu_torch.train import mine  # noqa: E402
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402
from cascadeclassifier_tpu_torch.train.split import scan_cumsum  # noqa: E402
from cascadeclassifier_tpu_torch.utils import edges  # noqa: E402

LEVELS = 3  # csrc/mine.cu's kLevels
EPS = 1e-5


# -- a numpy replay of csrc/mine.cu ------------------------------------------


def _axis_tab_c(ssz: int, dsz: int, d):
    """mine.cu's axis_tab over the coordinates d (int64): C's truncating
    division corrected to a floor, as the kernel does."""
    two = 2 * dsz
    num = (2 * d + 1) * ssz - dsz
    qt = np.sign(num) * (np.abs(num) // two)
    sx = np.where((num - qt * two != 0) & (num < 0), qt - 1, qt)
    a = 128 * (num - sx * two)
    q = a // dsz
    r = a - q * dsz
    c = q + ((2 * r > dsz) | ((2 * r == dsz) & (q % 2 == 1)))
    c = np.where(sx < 0, 0, c)
    sx = np.where(sx < 0, 0, sx)
    hi = sx >= ssz - 1
    sx = np.where(hi, ssz - 2 if ssz > 1 else 0, sx)
    c = np.where(hi, 256 if ssz > 1 else 0, c)
    oob = d >= dsz
    sx, c = np.where(oob, 0, sx), np.where(oob, 0, c)
    return sx, np.minimum(sx + 1, ssz - 1), c


def _pixels_in_numpy(levels, ww, wh):
    """(n, wh, ww) int64: each window's pixels as the kernel builds them."""
    table = levels.table.numpy()
    lazy, eager = levels.lazy.numpy(), levels.eager.numpy()
    sy, sx = wh // 2, ww // 2
    out = []
    for row in table:
        k = np.arange(row[mine.COUNT])
        q = row[mine.W0] + k
        y0 = row[mine.OY] + (q // row[mine.NX]) * sy
        x0 = row[mine.OX] + (q % row[mine.NX]) * sx
        ys = y0[:, None] + np.arange(wh)  # (m, wh)
        xs = x0[:, None] + np.arange(ww)  # (m, ww)
        sh, sw, dh, dw = row[mine.SH], row[mine.SW], row[mine.DH], row[mine.DW]
        if row[mine.EAGER]:
            img = eager[row[mine.SRC_OFF]:row[mine.SRC_OFF] + sh * sw].reshape(sh, sw)
            out.append(img[ys[:, :, None], xs[:, None, :]].astype(np.int64))
            continue
        src = lazy[row[mine.SRC_OFF]:row[mine.SRC_OFF] + sh * sw].reshape(sh, sw).astype(np.int64)
        ry0, ry1, cy = _axis_tab_c(sh, dh, ys)
        cx0, cx1, cx = _axis_tab_c(sw, dw, xs)
        g = lambda r, c: src[r[:, :, None], c[:, None, :]]  # noqa: E731
        cyb = cy[:, :, None]
        v0 = (256 - cyb) * g(ry0, cx0) + cyb * g(ry1, cx0)
        v1 = (256 - cyb) * g(ry0, cx1) + cyb * g(ry1, cx1)
        h = (256 - cx[:, None, :]) * v0 + cx[:, None, :] * v1
        v = np.minimum((h + (1 << 15)) >> 16, 255)
        inside = (ys[:, :, None] < dh) & (xs[:, None, :] < dw)
        out.append(np.where(inside, v, 0))
    return np.concatenate(out)


def _integral_in_numpy(pix):
    """The kernel's sum integral: chunks of 32 columns, a column sum down
    the rows a lane, scanned across the lanes, plus the last value of the
    previous chunk in the same row."""
    m, wh, ww = pix.shape
    s = np.zeros((m, wh + 1, ww + 1), np.int64)
    for cb in range(0, ww, 32):
        c = cb + np.arange(32)
        ok = c < ww
        col = np.zeros((m, 32), np.int64)
        for r in range(wh):
            col[:, ok] += pix[:, r, c[ok]]
            incl = np.cumsum(col, axis=1)
            carry = s[:, r + 1, cb] if cb else 0
            s[:, r + 1, c[ok] + 1] = (incl + (carry[:, None] if cb else 0))[:, ok]
    return s


def _tilted_in_numpy(pix):
    """The kernel's tilted integral: the row recurrence over rows padded
    with wh + 1 zero columns each side, three rolling rows."""
    m, wh, ww = pix.shape
    p = wh + 1
    pw = ww + 2 * p
    x = np.arange(pw + 1)
    xc = x - 1 - p
    inb = (xc >= 0) & (xc < ww)
    tm2 = np.zeros((m, pw + 1), np.int64)
    tm1 = np.zeros((m, pw + 1), np.int64)
    t = np.zeros((m, wh + 1, ww + 1), np.int64)
    for y in range(wh):
        r1 = np.where(inb, pix[:, y, np.clip(xc, 0, ww - 1)], 0)
        r0 = np.where(inb, pix[:, y - 1, np.clip(xc, 0, ww - 1)], 0) if y > 0 else 0
        left = np.concatenate([np.zeros((m, 1), np.int64), tm1[:, :-1]], axis=1)
        right = np.concatenate([tm1[:, 1:], np.zeros((m, 1), np.int64)], axis=1)
        tn = left + right - tm2 + r1 + r0
        t[:, y + 1] = tn[:, p:p + ww + 1]
        tm2, tm1 = tm1, tn
    return t


def _stream_prefix(leaves):
    """(m, T) f64 leaves → (m, T) prefixes as the kernel carries them: 32
    trees a step, each lane's sequential sum in its block of 16 from 0.0,
    plus its block's exclusive prefix; a completed block's total moves up
    LEVELS carried levels (an accumulator and an exclusive prefix each)."""
    m, n_t = leaves.shape
    acc = [np.zeros(m) for _ in range(LEVELS + 1)]
    ex = [np.zeros(m) for _ in range(LEVELS + 2)]
    cnt = [0] * (LEVELS + 1)

    def push(x):
        for lv in range(1, LEVELS + 1):
            acc[lv] = acc[lv] + x
            ex[lv] = acc[lv] + ex[lv + 1]
            cnt[lv] += 1
            if cnt[lv] < 16:
                break
            x, acc[lv], cnt[lv] = acc[lv], np.zeros(m), 0

    pref = np.zeros((m, n_t))
    for t0 in range(0, n_t, 32):
        x = np.zeros((m, 32))
        x[:, :min(32, n_t - t0)] = leaves[:, t0:t0 + 32]
        s = np.zeros((m, 32))
        for lane in range(32):
            a = np.zeros(m)
            for k in range(16):
                if k <= lane & 15:
                    a = a + x[:, (lane & 16) + k]
            s[:, lane] = a
        ex_a = ex[1]
        push(s[:, 15])
        ex_b = ex[1]
        push(s[:, 31])
        step = s + np.where(np.arange(32) < 16, ex_a[:, None], ex_b[:, None])
        pref[:, t0:t0 + 32] = step[:, :min(32, n_t - t0)]
    return pref


def _mine_kernel_in_numpy(levels, feats, trees, ww, wh):
    """csrc/mine.cu in numpy, every window at once → (n,) uint8."""
    if levels.n == 0:
        return np.zeros(0, np.uint8)
    pix = _pixels_in_numpy(levels, ww, wh)
    s = _integral_in_numpy(pix).reshape(len(pix), -1)
    ti = trees.feature.numpy()
    if feats.points is not None:
        pts = feats.points.numpy()[ti]  # (T, 16)
        gp = s[:, pts]  # (m, T, 16)
        cs = [gp[..., r * 4 + c] - gp[..., r * 4 + c + 1] - gp[..., (r + 1) * 4 + c]
              + gp[..., (r + 1) * 4 + c + 1] for r in range(3) for c in range(3)]
        code = sum((cs[i] >= cs[4]).astype(np.int64) << b
                   for i, b in ((0, 7), (1, 6), (2, 5), (5, 4), (8, 3), (7, 2), (6, 1), (3, 0)))
        words = trees.subsets.numpy().view(np.uint32)
        left = ((words[np.arange(len(ti)), code >> 5] >> (code & 31)) & 1) != 0
    else:
        tilted = _tilted_in_numpy(pix).reshape(len(pix), -1) if feats.has_tilted else s
        rh, rw, w1 = wh - 2, ww - 2, ww + 1
        inner = pix[:, 1:wh - 1, 1:ww - 1]
        sq = (inner * inner).sum(axis=(1, 2))
        lo = (1 + rh) * w1
        tot = s[:, w1 + 1] - s[:, w1 + 1 + rw] - s[:, lo + 1] + s[:, lo + 1 + rw]
        nf = np.sqrt(np.maximum(rh * rw * sq - tot * tot, 0).astype(np.float64)).astype(np.float32)
        off, w = feats.offsets.numpy()[ti], feats.weights.numpy()[ti]
        til = feats.tilted.numpy()[ti].astype(bool)
        raw = np.zeros((len(pix), len(ti)), np.int64)
        for r in range(3):
            o = off[:, r]
            def rect(img):
                return img[:, o[:, 0]] - img[:, o[:, 1]] - img[:, o[:, 2]] + img[:, o[:, 3]]

            raw += w[:, r] * np.where(til, rect(tilted), rect(s))
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.where(nf[:, None] != 0, raw.astype(np.float32) / nf[:, None], np.float32(0))
        left = v <= trees.thr.numpy()
    leaves = np.where(left, trees.left.numpy(), trees.right.numpy()).astype(np.float64)
    pref = _stream_prefix(leaves)
    alive = np.ones(len(pix), bool)
    start = np.zeros(len(pix))
    for end, thr in zip(trees.stage_end.numpy(), trees.stage_thr.numpy()):
        pe = pref[:, end - 1]
        alive &= ~(pe - start < thr - EPS)
        start = pe
    return alive.astype(np.uint8)


# -- the cases -----------------------------------------------------------------


def _jax_evaluator(feature, ww, wh):
    if feature == "LBP":
        return JLBPTrainEvaluator(jfeatures.lbp_catalog(ww, wh))
    return JHaarTrainEvaluator(jfeatures.haar_catalog(ww, wh, feature))


def _case(feature, ww, wh, sizes, seed, pass_rate):
    """(the port's levels and stages, the JAX package's levels and
    stages) of one case; the JAX stages are built from the specs and the
    port's taken from them by stages_from_jax. Past 17 trees the stage
    thresholds sit on windows that a prefix in another order than
    scan_cumsum's would judge the other way (stump_specs's knife)."""
    levels, _stages, specs = edges.mine_case(feature, ww, wh, sizes, seed, pass_rate=pass_rate,
                                             knife=sum(sizes) > 17)
    jstages = edges.stages_of(specs, JStage, JWeakTree)
    jlevels = edges.levels_of(edges.mine_level_specs(seed, ww, wh), JLazyLevel)
    return levels, stages_from_jax(jstages), jlevels, jstages


CASES = [
    ("BASIC", 12, (1,), 0.4), ("BASIC", 12, (16,), 0.75), ("BASIC", 12, (5, 12), 0.75),
    ("BASIC", 12, (3, 17, 20), 0.8), ("BASIC", 12, (100, 156), 0.8),
    ("BASIC", 12, (16, 240, 45), 0.8), ("BASIC", 24, (17,), 0.75),
    ("BASIC", 24, (255, 2), 0.75), ("ALL", 12, (3, 17, 20), 0.8),
    ("ALL", 24, (16, 240, 45), 0.8), ("LBP", 12, (5, 12), 0.75), ("LBP", 24, (100, 201), 0.8),
]


@pytest.mark.parametrize("feature,side,sizes,pass_rate", CASES,
                         ids=[f"{f}-{s}-{sum(z)}" for f, s, z, _ in CASES])
def test_mine_matches_original(feature, side, sizes, pass_rate):
    """The port's dense predict_levels (mine_ref) and the kernel's replay
    give the JAX package's dense masks."""
    seed = 50 + sum(sizes) + side
    levels, stages, jlevels, jstages = _case(feature, side, side, sizes, seed, pass_rate)
    want = JPredictor(lambda: _jax_evaluator(feature, side, side), jstages).predict_levels(
        jlevels, side, side)
    ev = edges.mine_evaluator(feature, side, side, "cpu")
    got = CascadePredictor(lambda: ev, stages).predict_levels(levels, side, side)
    assert [len(g) for g in got] == [len(lv[1]) for lv in levels]
    flat = np.concatenate(got)
    assert 0.05 <= flat.mean() <= 0.95
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    args = edges.mine_inputs(feature, side, side, levels, stages, "cpu")
    np.testing.assert_array_equal(_mine_kernel_in_numpy(*args, side, side), flat)


@pytest.mark.parametrize("case", range(17))
def test_kernel_replay_edge_cases(case):
    """utils/edges.py's miner edges (the cases chip_smoke runs on the
    card): the kernel's replay equals mine_ref."""
    label, feature, ww, wh, levels, stages = list(edges.mine_edge_cases())[case]
    args = edges.mine_inputs(feature, ww, wh, levels, stages, "cpu")
    want = mine.mine_ref(*args, ww, wh).numpy()
    np.testing.assert_array_equal(_mine_kernel_in_numpy(*args, ww, wh), want, err_msg=label)


def test_edge_cases_count():
    assert len(list(edges.mine_edge_cases())) == 17


@pytest.mark.parametrize("n_trees", [1, 15, 16, 17, 31, 32, 33, 255, 256, 257, 300, 4097])
def test_stream_prefix_is_scan_cumsum(n_trees):
    """Bit (1): the kernel's streaming prefix equals scan_cumsum's blocked
    order bit for bit past every block boundary; a running sum in tree
    order does not (f64 leaves, once a second block holds two trees)."""
    rng = np.random.default_rng(n_trees)
    for leaves in (rng.normal(0, 1, (64, n_trees)).astype(np.float32).astype(np.float64),
                   rng.normal(0, 1, (64, n_trees))):
        got = _stream_prefix(leaves)
        want = scan_cumsum(torch.from_numpy(leaves.T.copy())).numpy().T
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
    if n_trees > 17:
        assert not np.array_equal(np.cumsum(leaves, axis=1), want)


def test_stream_prefix_of_negative_zero_leaves():
    """-0.0 leaves: the streaming prefix and scan_cumsum agree as values
    (a zero sum's sign may differ at the top level; no compare sees it)."""
    leaves = np.full((4, 40), -0.0)
    leaves[1, ::3] = 1.5
    np.testing.assert_array_equal(_stream_prefix(leaves),
                                  scan_cumsum(torch.from_numpy(leaves.T.copy())).numpy().T)


def _levels_for_packing():
    specs = edges.mine_level_specs(7, 12, 12)
    levels = edges.levels_of(specs, LazyLevel)
    img, pos, key = levels[0]
    rng = np.random.default_rng(3)
    scattered = pos[np.sort(rng.choice(len(pos), 9, replace=False))]  # several runs
    return levels + [(img, scattered, key), (img, pos[::-1], key)]


def test_pack_levels_covers_positions_in_order():
    levels = _levels_for_packing()
    packed = mine.pack_levels(levels, 12, 12, "cpu")
    table = packed.table.numpy()
    assert packed.counts == [len(lv[1]) for lv in levels]
    assert packed.n == sum(packed.counts) == int(table[:, mine.COUNT].sum())
    assert (table[:, mine.COUNT] > 0).all()
    np.testing.assert_array_equal(table[:, mine.OUT],
                                  np.concatenate(([0], np.cumsum(table[:-1, mine.COUNT]))))
    got = []
    for row in table:
        q = row[mine.W0] + np.arange(row[mine.COUNT])
        got.append(np.stack([row[mine.OX] + (q % row[mine.NX]) * 6,
                             row[mine.OY] + (q // row[mine.NX]) * 6], 1))
    want = np.concatenate([lv[1] for lv in levels if len(lv[1])])
    np.testing.assert_array_equal(np.concatenate(got), want)
    wins = mine.level_windows(packed, 12, 12).numpy()
    crops = np.stack([np.asarray(img[py:py + 12, px:px + 12])
                      for img, pos, _k in levels for px, py in pos])
    np.testing.assert_array_equal(wins, crops)
    np.testing.assert_array_equal(_pixels_in_numpy(packed, 12, 12), crops)
    # the schedule's levels (partial first row, then full rows) take a row
    # each, the empty one none
    assert int((table[:, mine.OUT] < sum(packed.counts[:6])).sum()) == 5


def test_pack_levels_reuses_arena_sources():
    levels = edges.levels_of(edges.mine_level_specs(7, 12, 12), LazyLevel)
    arena = mine.SourceArena("cpu")
    first = mine.pack_levels(levels, 12, 12, "cpu", arena)
    used = arena.used
    second = mine.pack_levels(levels[::-1], 12, 12, "cpu", arena)
    assert arena.used == used
    lazy0 = first.table[first.table[:, mine.EAGER] == 0][:, mine.SRC_OFF]
    assert set(lazy0.tolist()) <= set(second.table[:, mine.SRC_OFF].tolist())


def test_arena_starts_over_past_its_cap(monkeypatch):
    """Past ARENA_CAP_BYTES the arena drops its sources and holds those of
    the call at hand; the windows stay the levels' own."""
    levels = [lv for lv in edges.levels_of(edges.mine_level_specs(7, 12, 12), LazyLevel)
              if hasattr(lv[0], "src") and len(lv[1])]
    sizes = {(lv[0].src_id, lv[0].src.shape): lv[0].src.size for lv in levels}
    assert len(sizes) >= 2
    monkeypatch.setattr(mine, "ARENA_CAP_BYTES", max(sizes.values()))
    arena = mine.SourceArena("cpu")
    for lv in levels + levels[::-1]:
        packed = mine.pack_levels([lv], 12, 12, "cpu", arena)
        assert arena.used <= mine.ARENA_CAP_BYTES and len(arena.offsets) == 1
        crops = np.stack([np.asarray(lv[0][py:py + 12, px:px + 12]) for px, py in lv[1]])
        np.testing.assert_array_equal(mine.level_windows(packed, 12, 12).numpy(), crops)


@pytest.mark.parametrize("bad", ["off grid", "past the level"])
def test_pack_levels_rejects_positions(bad):
    img = np.zeros((40, 40), np.uint8)
    pos = np.array([[0, 0], [6, 0], [3, 0]] if bad == "off grid" else [[0, 0], [30, 0]])
    with pytest.raises(ValueError):
        mine.pack_levels([(img, pos, 0)], 12, 12, "cpu")


@pytest.mark.parametrize("feature,side", [("BASIC", 24), ("ALL", 24), ("LBP", 24),
                                          ("BASIC", 20)])
def test_check_exact_holds_for_whole_catalogs(feature, side):
    ev = edges.mine_evaluator(feature, side, side, "cpu")
    feats = mine.features_of(ev, np.arange(ev.num_features))
    assert 0 < mine.exact_bound(feats, side, side) <= mine.EXACT_LIMIT


@pytest.mark.parametrize("what", ["weight", "window", "lbp"])
def test_check_exact_fires_beyond_2_24(what):
    """Bit (3): a synthetic feature whose partial sums may pass 2^24: a
    BASIC feature at 24x24 with its weights x 4096; an x2 feature over a
    256x256 window (255 · 256² · 3 > 2^24); LBP cells of 100x100 pixels
    in a 300x300 window."""
    if what == "lbp":
        c = np.array([0, 100, 200, 300])
        pts = (c[None, :] + 301 * c[:, None]).reshape(1, 16)
        feats = mine.Features(points=torch.from_numpy(pts).to(torch.int32))
        with pytest.raises(ValueError, match="2\\^24"):
            mine.check_exact(feats, 300, 300)
        return
    if what == "weight":
        side = 24
        ev = edges.mine_evaluator("BASIC", side, side, "cpu")
        off, w, til = ev.kernel_records(torch.tensor([len(ev.catalog) - 1]))
        w = w * 4096
    else:
        side = 256
        rects = np.array([[0, 0, side, side], [0, 0, side // 2, side], [0, 0, 0, 0]])
        off = np.stack(sum_offsets(*rects.T, side + 1), axis=-1)[None]
        off = torch.from_numpy(off).to(torch.int32)
        w = torch.tensor([[-1, 2, 0]], dtype=torch.int32)
        til = torch.zeros(1, dtype=torch.int32)
    feats = mine.Features(offsets=off, weights=w, tilted=til)
    with pytest.raises(ValueError, match="2\\^24"):
        mine.check_exact(feats, side, side)


def test_exact_check_guards_the_kernel_only():
    """Bit (3) holds the kernel to the plain version: its wrapper raises
    beyond 2^24 before a launch, while the plain version mines such
    features, as the JAX package does."""
    ev = edges.mine_evaluator("BASIC", 24, 24, "cpu")
    feats = mine.features_of(ev, [len(ev.catalog) - 1])
    feats.weights = feats.weights * 4096
    img = np.random.default_rng(3).integers(0, 256, (48, 48), dtype=np.uint8)
    pos = np.array([[x, y] for y in (0, 12, 24) for x in (0, 12, 24)])
    packed = mine.pack_levels([(img, pos, 0)], 24, 24, "cpu")
    trees = mine.Trees(torch.zeros(1, dtype=torch.int32), torch.zeros(1), torch.ones(1),
                       -torch.ones(1), None, torch.ones(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="2\\^24"):
        mine._check_args(packed, feats, trees, 24, 24)
    got = mine.mine(packed, feats, trees, 24, 24)
    torch.testing.assert_close(got, mine.mine_ref(packed, feats, trees, 24, 24), rtol=0, atol=0)
    assert got.shape == (9,)


def test_tilted_edge_features_touch_the_edge():
    cat = haar_catalog(24, 24, "ALL")
    ids = edges.tilted_edge_features(cat)
    assert len(ids) > 100 and cat.tilted[ids].all()
    off = cat.corner_offsets()[ids]
    col, row = off % 25, off // 25
    used = cat.weights[ids] != 0
    touch = ((col == 0) | (col == 24) | (row == 24)) & used[:, :, None]
    assert touch.any(axis=(1, 2)).all()


def test_empty_inputs():
    """No windows: an empty mask; no stages: every window accepted."""
    ev = edges.mine_evaluator("BASIC", 12, 12, "cpu")
    levels = edges.levels_of(edges.mine_level_specs(7, 12, 12), LazyLevel)
    stages = edges.mine_case("BASIC", 12, 12, (3,), 9)[1]
    feats, trees = mine.features_of(ev, [0]), mine.tree_table([], [0], False, "cpu")
    packed = mine.pack_levels(levels, 12, 12, "cpu")
    assert mine.mine(packed, feats, trees, 12, 12).tolist() == [1] * packed.n
    empty = mine.pack_levels([(levels[4][0], levels[4][1], 0)], 12, 12, "cpu")
    assert empty.n == 0 and mine.mine(empty, feats, trees, 12, 12).numel() == 0
    pred = CascadePredictor(lambda: ev, stages)
    assert pred.predict_levels([], 12, 12) == []
    assert [len(x) for x in pred.predict_levels(levels[4:5], 12, 12)] == [0]
