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
                  "tied_means": (10, 256, 10), "n3000": (3, 3000, 11)}[case]
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
    w /= w.sum()
    return codes, w, resp, mask


CAT_CASES = ["test_train", "n20", "n32", "n33", "n77", "masked", "one_category",
             "few_categories", "tied_means", "n3000"]


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


WINDOW, MAX_LEVELS = 32, 4  # csrc/cat_split.cu: kWindow, kMaxLevels


def _bin_in_numpy(x, match):
    """One thread of csrc/cat_split.cu's histogram: the tree of windows
    (cct_cat_split's Tree) fed sample by sample, the matching samples
    added into the open window of level 0, closed windows carried up
    (push_up), the top level one sequential run."""
    n = len(x)
    lens, los = [n], [0]
    while lens[-1] > WINDOW:
        padded = -(-lens[-1] // WINDOW) * WINDOW
        los[-1] = (padded - lens[-1]) // 2
        lens.append(padded // WINDOW)
        los.append(0)
    levels = len(lens) - 1
    assert levels <= MAX_LEVELS
    acc, cnt = [0.0] * (levels + 1), [0] * (levels + 1)
    for i in range(n):
        p = los[0] + i
        if p % WINDOW == 0 or i == 0:
            acc[0] = 0.0
        if match[i]:
            acc[0] += float(x[i])
        if levels > 0 and (p % WINDOW == WINDOW - 1 or i == n - 1):
            v = acc[0]
            for lv in range(1, levels + 1):
                if lv == levels:
                    acc[lv] += v
                    break
                q = los[lv] + cnt[lv]
                acc[lv] = (0.0 if q % WINDOW == 0 or cnt[lv] == 0 else acc[lv]) + v
                cnt[lv] += 1
                if not (q % WINDOW == WINDOW - 1 or cnt[lv] == lens[lv]):
                    break
                v = acc[lv]
    return acc[levels]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000, 1025, 1056, 3000, 33000])
def test_kernel_histogram_walk_in_numpy_matches_plain(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 3, (1, n)).astype(np.int32)
    x = rng.random(n) * rng.random(n) ** 8
    hist = cat_split.histograms(torch.from_numpy(codes), torch.from_numpy(x)[None])[0, 0].numpy()
    for c in range(3):
        assert _bin_in_numpy(x, codes[0] == c) == hist[c]


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
