"""LBP training in the port against the JAX package on the CPU: the
catalog (and the reference's goldens), the codes of eval_lbp and of the
training evaluator, the categorical split's plain versions bit for bit
against _categorical_split_block and _categorical_class_split_block, the
predictor's categorical walk and dense miner, 12x12 toy runs whose files
and transcript equal the JAX trainer's, and (cuda-marked) the
categorical kernel against its plain versions on the card."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cascadeclassifier_tpu.data.negreader import NegReader as JNegReader  # noqa: E402
from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.ops.integral import integral_image as jintegral_image  # noqa: E402
from cascadeclassifier_tpu.train import boost as jboost  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    LBPTrainEvaluator as JLBPTrainEvaluator,
)
from cascadeclassifier_tpu.train.predictor import CascadePredictor as JPredictor  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.convert import stages_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.data.negreader import NegReader  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import (  # noqa: E402
    BOOST_DAB,
    BOOST_GAB,
    BOOST_LB,
    BOOST_RAB,
    FEATURE_LBP,
)
from cascadeclassifier_tpu_torch.ops.features import eval_lbp, lbp_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.train import boost, cat_split  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import LBPTrainEvaluator  # noqa: E402
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    cat_split_edge_mismatches,
    skewed_codes,
)

from .test_features import _load_geom, _load_imgs, _load_resp  # noqa: E402
from .test_torch_train_boost_types import assert_same_run, diag_data, toy_both  # noqa: E402
from .test_torch_train_stage import _samples  # noqa: E402


@pytest.mark.parametrize("win", [(12, 12), (24, 24), (75, 32)])
def test_lbp_catalog_matches_original(win):
    ours, theirs = lbp_catalog(*win), jfeatures.lbp_catalog(*win)
    np.testing.assert_array_equal(ours.rects, theirs.rects)
    np.testing.assert_array_equal(ours.cell_offsets(), theirs.cell_offsets())
    assert len(ours) == {(12, 12): 484, (24, 24): 8_464, (75, 32): 152_625}[win]


def test_lbp_catalog_matches_reference(golden_dir):
    for name, (w, h) in [("geom_lbp_12x10.txt.gz", (12, 10)), ("geom_lbp_9x7.txt.gz", (9, 7))]:
        count, rows = _load_geom(golden_dir, name)
        cat = lbp_catalog(w, h)
        assert len(cat) == count
        np.testing.assert_array_equal(cat.rects, np.array([[int(v) for v in r[1:]] for r in rows],
                                                          np.int32))


def test_eval_lbp_matches_reference_and_original(golden_dir):
    w, h = 12, 10
    cat = lbp_catalog(w, h)
    imgs = _load_imgs(golden_dir, "img_lbp_12x10.txt.gz", h, w)
    ref = _load_resp(golden_dir, "resp_lbp_12x10.txt.gz", len(cat))
    s = np.array(jintegral_image(jnp.asarray(imgs))).reshape(4, -1)
    codes = eval_lbp(torch.from_numpy(s), torch.from_numpy(cat.cell_offsets())).numpy()
    np.testing.assert_array_equal(codes.astype(np.float64), ref)
    want = np.asarray(jfeatures.eval_lbp(jnp.asarray(s), jnp.asarray(cat.cell_offsets())))
    np.testing.assert_array_equal(codes, want)


def test_lbp_evaluator_matches_original():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (70, 12, 12)).astype(np.uint8)
    x[::5] = 128  # flat windows: every compare ties
    ours = LBPTrainEvaluator(lbp_catalog(12, 12), block_size=100, device="cpu")
    theirs = JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12), block_size=100)
    ours.set_samples(x)
    theirs.set_samples(x)
    assert ours.num_blocks() == theirs.num_blocks() == 5
    for b in range(ours.num_blocks()):
        got = ours.values_block(b)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(theirs.values_block(b)))
    ids = [3, 400, 17, 17, 483]
    np.testing.assert_array_equal(ours.values_for_vars(ids).numpy(),
                                  np.asarray(theirs.values_for_vars(ids)))


def _codes_case(case):
    """(codes (B, N), w, resp, mask) of one parametrised case."""
    b, n, seed = {"test_train": (5, 300, 2), "n20": (7, 20, 3), "n32": (7, 32, 4),
                  "n33": (7, 33, 5), "n77": (9, 77, 6), "masked": (8, 500, 7),
                  "one_category": (6, 200, 8), "few_categories": (12, 400, 9),
                  "tied_means": (10, 256, 10), "n3000": (3, 3000, 11),
                  "skewed": (8, 1000, 12)}[case]
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (b, n)).astype(np.int32)
    w = rng.random(n) ** 3
    resp = rng.choice([-1.0, 1.0], n)
    mask = np.ones(n, bool)
    if case == "test_train":  # tests/test_train.py's categorical case
        w = rng.uniform(0.1, 1.0, n)
        codes = np.random.default_rng(2).integers(0, 256, (b, n)).astype(np.int32)
    if case == "masked":
        mask = rng.random(n) > 0.4
    if case == "one_category":
        codes[:] = 77
        codes[1] = 0
        codes[2, : n // 2] = 255
    if case == "few_categories":  # most of the 256 bins empty
        codes = rng.choice(np.array([0, 3, 31, 32, 200], np.int32), (b, n))
    if case == "tied_means":  # dyadic weights, categories of one class each: exact ties
        w = rng.integers(1, 8, n) / 64.0
        codes = rng.integers(0, 16, (b, n)).astype(np.int32)
        resp = np.where(codes[0] % 2 == 0, 1.0, -1.0)
    if case == "skewed":  # like real LBP codes: most samples on a few uniform patterns
        codes = skewed_codes(rng, b, n)
    w /= w.sum()
    return codes, w, resp, mask


CAT_CASES = ["test_train", "n20", "n32", "n33", "n77", "masked", "one_category",
             "few_categories", "tied_means", "n3000", "skewed"]


@pytest.mark.parametrize("policy", ["reg", "misclass", "gini"])
@pytest.mark.parametrize("case", CAT_CASES)
def test_categorical_plain_matches_original(case, policy):
    codes, w, resp, mask = _codes_case(case)
    wm = np.where(mask, w, 0.0)
    t = torch.from_numpy
    if policy == "reg":
        q, sub = jboost._categorical_split_block(jnp.asarray(codes), jboost.as_f64(w),
                                                 jboost.as_f64(resp), jnp.asarray(mask))
        gq, gsub = cat_split.categorical_split(t(codes), t(wm), t(wm * resp))
    else:
        cls = (resp > 0).astype(np.int32)
        q, sub = jboost._categorical_class_split_block(
            jnp.asarray(codes), jboost.as_f64(w), jnp.asarray(cls), jnp.asarray(mask),
            policy == "gini")
        gq, gsub = cat_split.categorical_class_split(
            t(codes), t(np.where(cls == 0, wm, 0.0)), t(np.where(cls == 1, wm, 0.0)),
            policy == "gini")
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gsub.numpy(), np.asarray(sub))
    assert gsub.dtype == torch.int32 and gsub.shape == (codes.shape[0], 8)
    if case == "one_category":
        assert np.isinf(np.asarray(q)[0])  # a single category cannot split


def test_histograms_follow_the_tree_order():
    """The bins equal a sequential sum only up to rounding: the tree of
    windows of 32 is what the JAX package adds, and it differs here."""
    rng = np.random.default_rng(3)
    n = 3000
    codes = rng.integers(0, 4, (2, n)).astype(np.int32)
    x = rng.random(n) * rng.random(n) ** 8
    hist = cat_split.histograms(torch.from_numpy(codes), torch.from_numpy(x)[None])[0].numpy()
    seq = np.zeros((2, 256))
    for f in range(2):
        for i in range(n):
            seq[f, codes[f, i]] += x[i]
    np.testing.assert_allclose(hist, seq, rtol=1e-12)
    assert (hist != seq).any()


def _lbp_stages(seed=0):
    """Two trained LBP stages (global indices) from the JAX package."""
    samples, labels, valid = _samples(seed=seed)
    jev = JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12), block_size=256)
    jev.set_samples(samples)
    st0, _ = jboost.StageTrainer(jev, jboost.BoostParams(weak_count=4, max_false_alarm=0.2)).train(
        labels, valid=valid, verbose=False)
    st1, _ = jboost.StageTrainer(jev, jboost.BoostParams(weak_count=3)).train(
        1 - labels, valid=valid, verbose=False)
    st1.threshold = -1.0
    return [st0, st1]


def test_lbp_stage_trainer_matches_original():
    samples, labels, valid = _samples(pad=26)
    ev = LBPTrainEvaluator(lbp_catalog(12, 12), block_size=128, device="cpu")
    jev = JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12), block_size=128)
    ev.set_samples(samples)
    jev.set_samples(samples)
    params = boost.BoostParams(weak_count=8, max_false_alarm=0.05)
    s, sums = boost.StageTrainer(ev, params).train(labels, valid=valid, verbose=False)
    js, jsums = jboost.StageTrainer(jev, jboost.BoostParams(**dataclasses.asdict(params))).train(
        labels, valid=valid, verbose=False)
    assert len(s.trees) == len(js.trees) >= 2 and s.threshold == js.threshold
    for a, b in zip(s.trees, js.trees):
        assert a.threshold is None
        for f in ("left", "right", "feature_idx", "subsets", "leaf_values"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(sums, jsums)
    assert boost.FeatureCache(ev).n_idx == 0  # no sort machinery for codes


@pytest.mark.parametrize("n_stages", [1, 2])
def test_categorical_predict_batch_matches_original(n_stages):
    jstages = _lbp_stages()[:n_stages]
    rng = np.random.default_rng(9)
    win = rng.integers(0, 200, (300, 12, 12)).astype(np.uint8)
    win[::4, 3:9, 3:9] = 180
    jp = JPredictor(lambda: JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12)), jstages)
    ev = LBPTrainEvaluator(lbp_catalog(12, 12), device="cpu")
    ours = CascadePredictor(lambda: ev, stages_from_jax(jstages))
    got, want = ours.predict_batch(win), jp.predict_batch(win)
    assert 0 < got.sum() < len(win)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lazy", [False, True])
def test_categorical_predict_levels_matches_original(tmp_path, lazy):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    names = []
    for i, (h, w) in enumerate(((90, 120), (75, 64))):
        img = rng.integers(0, 200, (h, w)).astype(np.uint8)
        img[10:40, 10:40] = 170
        p = str(tmp_path / f"bg{i}.png")
        cv2.imwrite(p, img)
        names.append(p)
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    jstages = _lbp_stages(seed=1)
    ours_reader, their_reader = NegReader(bg, 12, 12, lazy=lazy), JNegReader(bg, 12, 12, lazy=lazy)
    levels, jlevels = [], []
    for _ in range(25):
        for rd, out in ((ours_reader, levels), (their_reader, jlevels)):
            img, pos = rd.level_positions()
            out.append((img, pos, (rd.last, float(rd.scale))))
            rd.skip(len(pos) - 1 if len(out) % 3 == 0 else len(pos))
    jp = JPredictor(lambda: JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12)), jstages)
    ev = LBPTrainEvaluator(lbp_catalog(12, 12), device="cpu")
    ours = CascadePredictor(lambda: ev, stages_from_jax(jstages))
    got, want = ours.predict_levels(levels, 12, 12), jp.predict_levels(jlevels, 12, 12)
    flat = np.concatenate(got)
    assert 0 < flat.sum() < len(flat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("boost_type", ["GAB", "DAB", "RAB", "LB"])
def test_lbp_toy_run_matches_original(tmp_path, boost_type):
    bt = {"GAB": BOOST_GAB, "DAB": BOOST_DAB, "RAB": BOOST_RAB, "LB": BOOST_LB}[boost_type]
    d = str(tmp_path)
    diag_data(d)
    ours, theirs = toy_both(d, FEATURE_LBP, "BASIC",
                            boost.BoostParams(boost_type=bt, max_false_alarm=0.05, weak_count=6))
    assert_same_run(d, ours, theirs)
    model = ours[0]
    assert model.num_stages == 3 and sum(len(s.trees) for s in model.stages) >= 6
    assert all(t.subsets is not None for s in model.stages for t in s.trees)


def test_lbp_trainer_resumes_from_its_checkpoint(tmp_path):
    """The LBP stages load back (max_cat_count through load and
    read_stage_xml) and the resumed trainer writes the same cascade."""
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer

    d = str(tmp_path)
    diag_data(d)
    ours, _ = toy_both(d, FEATURE_LBP, "BASIC", boost.BoostParams(max_false_alarm=0.05,
                                                                   weak_count=6))
    again = CascadeTrainer(feature_type=FEATURE_LBP, win_w=12, win_h=12, device="cpu")
    assert again.load(os.path.join(d, "port"))
    assert len(again.stages) == ours[0].num_stages and again.max_cat_count == 256
    for a, b in zip(again.stages, ours[0].stages):
        for ta, tb in zip(a.trees, b.trees):
            np.testing.assert_array_equal(ta.subsets, tb.subsets)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["reg", "misclass", "gini"])
@pytest.mark.parametrize("case", CAT_CASES + ["n70000"])
def test_cat_split_kernel_matches_plain(cuda_device, case, policy):
    """Both load policies of the tables: shared memory up to a few thousand
    samples, global memory at 70 000."""
    if case == "n70000":
        rng = np.random.default_rng(1)
        codes = rng.integers(0, 256, (40, 70000)).astype(np.int32)
        w = rng.random(70000) ** 3
        w /= w.sum()
        resp, mask = rng.choice([-1.0, 1.0], 70000), rng.random(70000) > 0.1
    else:
        codes, w, resp, mask = _codes_case(case)
    wm = np.where(mask, w, 0.0)
    cls = resp > 0
    t0, t1 = ((wm, wm * resp) if policy == "reg"
              else (np.where(cls, 0.0, wm), np.where(cls, wm, 0.0)))
    args = [torch.from_numpy(a) for a in (codes, t0, t1)]
    run = ((lambda c, a, b: cat_split.categorical_split(c, a, b)) if policy == "reg"
           else (lambda c, a, b: cat_split.categorical_class_split(c, a, b, policy == "gini")))
    want = run(*args)
    before = _build.LAUNCHES["cat_split"]
    got = run(*[a.to(cuda_device) for a in args])
    assert _build.LAUNCHES["cat_split"] == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_cat_split_kernel_edges(cuda_device):
    """utils/edges.py's categorical cases (the chip_smoke (o) set): sample
    counts at the tree's levels, windows of one code, one-category
    features, blocks around one wave of warps; every policy bit for bit."""
    n_cases, bad = cat_split_edge_mismatches(cuda_device)
    assert n_cases == 36 and not bad, bad


WINDOW, MAX_LEVELS, NCAT = 32, 4, 256  # csrc/cat_split.cu: kWindow, kMaxLevels, kCats


def _tree(n):
    """cct_cat_split's Tree: each level's item count and front padding."""
    lens, los = [n], [0]
    while lens[-1] > WINDOW:
        padded = -(-lens[-1] // WINDOW) * WINDOW
        los[-1] = (padded - lens[-1]) // 2
        lens.append(padded // WINDOW)
        los.append(0)
    assert len(lens) - 1 <= MAX_LEVELS
    return lens, los


def _warp_walk_in_numpy(codes, x):
    """csrc/cat_split.cu's phase 1 for one feature, replayed: the warp
    takes the level-0 windows of 32 padded positions in turn (lane k holds
    sample 32 w - lo[0] + k; lanes past the row code -1, no category);
    lanes of equal codes form a group (__match_any_sync), which sums its
    values in lane order from +0.0, and the group's first lane adds the
    sum into its category's level-1 accumulator. Where (lo[1] + w) mod 32
    == 31, or at the last window, the level-1 windows close: every
    category's accumulator (a lane's 8 categories each; here all 256 at
    once, elementwise) is taken out, reset and carried up the upper levels
    (fold), the top level one sequential run. Returns the 256 bins."""
    n = len(codes)
    lens, los = _tree(n)
    levels = len(lens) - 1
    acc = np.zeros((max(levels, 1) + 1, NCAT))  # acc[l]: level l's open windows
    cnt = [0] * (MAX_LEVELS + 1)
    nw = lens[1] if levels else 1
    lanes = np.arange(WINDOW)
    for w in range(nw):
        i = w * WINDOW - los[0] + lanes
        inside = (i >= 0) & (i < n)
        code = np.where(inside, codes[np.clip(i, 0, n - 1)], -1)
        vals = np.where(inside, x[np.clip(i, 0, n - 1)], 0.0)
        for lane in lanes:
            group = np.flatnonzero(code == code[lane])
            if group[0] != lane or code[lane] < 0:  # a category's leader adds
                continue
            s = 0.0
            for k in group:
                s += float(vals[k])
            acc[1, code[lane]] += s
        if levels > 1 and ((los[1] + w) % WINDOW == WINDOW - 1 or w == nw - 1):
            v = acc[1].copy()
            acc[1] = 0.0
            for lv in range(2, levels + 1):
                if lv == levels:  # the top
                    acc[lv] = acc[lv] + v
                    break
                p = los[lv] + cnt[lv]
                acc[lv] = (0.0 if p % WINDOW == 0 or cnt[lv] == 0 else acc[lv]) + v
                v = acc[lv].copy()
                cnt[lv] += 1
                if not (p % WINDOW == WINDOW - 1 or cnt[lv] == lens[lv]):
                    break
    return acc[max(levels, 1)]


@pytest.mark.parametrize("n, one_code_window", [
    *(pytest.param(n, None, id=str(n))
      for n in (1, 31, 32, 33, 100, 1000, 1025, 1056, 3000, 33000, 70000)),
    pytest.param(3000, 10, id="group32"),
])
def test_kernel_histogram_walk_in_numpy_matches_plain(n, one_code_window):
    """The warp design's decomposition gives the plain bins bit for bit:
    at n = 70 000 the level-1 windows (lo[1] = 10) close off the multiples
    of 32 windows, and in "group32" every lane of window 10 holds one
    code (a group of 32)."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 3, (1, n)).astype(np.int32)
    x = rng.random(n) * rng.random(n) ** 8
    if one_code_window is not None:
        lo0 = _tree(n)[1][0]
        codes[0, one_code_window * WINDOW - lo0:(one_code_window + 1) * WINDOW - lo0] = 2
    hist = cat_split.histograms(torch.from_numpy(codes), torch.from_numpy(x)[None])[0, 0].numpy()
    np.testing.assert_array_equal(_warp_walk_in_numpy(codes[0], x), hist)


def _warp_sort_in_numpy(key):
    """csrc/cat_split.cu's bitonic sort: lane l, register r holds position
    8 l + r, category l + 32 r at the start; partners 8 positions or more
    apart are in lane l ^ (j / 8) (a shuffle), nearer ones in the same
    lane. Returns the categories in sorted order."""
    per = NCAT // WINDOW
    keys = np.array([[key[lane + WINDOW * r] for r in range(per)] for lane in range(WINDOW)])
    idx = np.array([[lane + WINDOW * r for r in range(per)] for lane in range(WINDOW)])

    def after(ka, ia, kb, ib):
        return ka > kb or (ka == kb and ia > ib)

    k = 2
    while k <= NCAT:
        j = k // 2
        while j > 0:
            if j >= per:
                lj = j // per
                nk, ni = keys.copy(), idx.copy()
                for lane in range(WINDOW):
                    o, lower = lane ^ lj, (lane & lj) == 0
                    for r in range(per):
                        up = ((lane * per + r) & k) == 0
                        mine = after(keys[lane, r], idx[lane, r], keys[o, r], idx[o, r])
                        if mine if lower == up else not mine:
                            nk[lane, r], ni[lane, r] = keys[o, r], idx[o, r]
                keys, idx = nk, ni
            else:
                for lane in range(WINDOW):
                    for r in range(per):
                        s = r | j
                        up = ((lane * per + r) & k) == 0
                        if not r & j and after(keys[lane, r], idx[lane, r], keys[lane, s],
                                               idx[lane, s]) == up:
                            keys[lane, [r, s]] = keys[lane, [s, r]]
                            idx[lane, [r, s]] = idx[lane, [s, r]]
            j //= 2
        k *= 2
    return idx.reshape(-1)


def _warp_scan_in_numpy(x):
    """csrc/cat_split.cu's prefix sums of the 256 sorted values: a block
    of 16 is lanes 2 b and 2 b + 1, each adding its 8 in turn from the
    even lane's +0.0, plus the sequential sum of the earlier blocks'
    totals."""
    per = NCAT // WINDOW
    q = np.empty((WINDOW, per))
    for lane in range(WINDOW):
        c = q[lane - 1, -1] if lane & 1 else 0.0
        for r, v in enumerate(x[lane * per:(lane + 1) * per]):
            c += float(v)
            q[lane, r] = c
    e = np.zeros(WINDOW)
    for lane in range(WINDOW):
        for k in range(lane >> 1):
            e[lane] += q[2 * k + 1, -1]
    return (q + e[:, None]).reshape(-1)


@pytest.mark.parametrize("case", ["test_train", "few_categories", "tied_means", "n3000"])
def test_kernel_sort_and_scans_in_numpy_match_plain(case):
    """The warp's sort network gives the stable argsort of the keys (ties
    and empty bins included), and its lane-pair scans jnp.cumsum's bits."""
    codes, w, resp, mask = _codes_case(case)
    wm = np.where(mask, w, 0.0)
    h0, h1 = cat_split.histograms(torch.from_numpy(codes),
                                  torch.from_numpy(np.stack([wm, wm * resp])))
    means = torch.where(h0.abs() > cat_split.DBL_EPSILON, h1 / h0, 0.0)
    for keys in (means, h1):
        order = torch.sort(keys, dim=1, stable=True).indices
        for f in range(codes.shape[0]):
            np.testing.assert_array_equal(_warp_sort_in_numpy(keys[f].numpy()), order[f].numpy())
    x = h0.gather(1, order)
    want = cat_split._cumsum_rows(x).numpy()
    for f in range(codes.shape[0]):
        np.testing.assert_array_equal(_warp_scan_in_numpy(x[f].numpy()), want[f])


@pytest.mark.parametrize("boost_type", ["GAB", "RAB"])
def test_trainer_from_jax_carries_lbp_and_boost_types(tmp_path, boost_type):
    """An LBP trainer of the JAX package with its boost type comes over
    with its stages; both predict the same and write the same cascade."""
    from cascadeclassifier_tpu.models.xml_io import write_cascade_xml as jwrite
    from cascadeclassifier_tpu.train.trainer import CascadeTrainer as JCascadeTrainer
    from cascadeclassifier_tpu_torch.convert import trainer_from_jax
    from cascadeclassifier_tpu_torch.models.xml_io import write_cascade_xml

    jt = JCascadeTrainer(feature_type=FEATURE_LBP, win_w=12, win_h=12,
                         boost=jboost.BoostParams(boost_type={"GAB": BOOST_GAB,
                                                              "RAB": BOOST_RAB}[boost_type]))
    jt.stages = _lbp_stages(seed=3)
    ours = trainer_from_jax(jt, device="cpu")
    assert ours.feature_type == FEATURE_LBP and ours.boost.__dict__ == jt.boost.__dict__
    rng = np.random.default_rng(1)
    win = rng.integers(0, 200, (200, 12, 12)).astype(np.uint8)
    np.testing.assert_array_equal(ours._predictor().predict_batch(win),
                                  jt._predictor().predict_batch(win))
    write_cascade_xml(ours._to_model(), str(tmp_path / "a.xml"))
    jwrite(jt._to_model(), str(tmp_path / "b.xml"))
    assert (tmp_path / "a.xml").read_bytes() == (tmp_path / "b.xml").read_bytes()
