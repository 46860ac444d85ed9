"""Deep weak trees (max_depth > 1) in the port against the JAX package on
the CPU: the stage trainer of every boost type at depth 2 and 3 (Haar and
LBP), its per-sample tree walk, the predictor's node walk on mixed stump
and deep cascades (positives and the miner), and 12x12 toy runs whose
files and transcript equal the JAX trainer's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.train import boost as jboost  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    LBPTrainEvaluator as JLBPTrainEvaluator,
)
from cascadeclassifier_tpu.train.predictor import CascadePredictor as JPredictor  # noqa: E402
from cascadeclassifier_tpu_torch.convert import stages_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import (  # noqa: E402
    BOOST_DAB,
    BOOST_GAB,
    BOOST_LB,
    BOOST_RAB,
    FEATURE_HAAR,
    FEATURE_LBP,
)
from cascadeclassifier_tpu_torch.ops.features import haar_catalog, lbp_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.train import boost, predictor  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator,
    LBPTrainEvaluator,
)
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402

from .test_torch_train_boost_types import assert_same_run, diag_data, toy_both  # noqa: E402
from .test_torch_train_stage import _samples  # noqa: E402

BOOSTS = {"GAB": BOOST_GAB, "DAB": BOOST_DAB, "RAB": BOOST_RAB, "LB": BOOST_LB}


def _evaluators(feature, block):
    if feature == "LBP":
        return (LBPTrainEvaluator(lbp_catalog(12, 12), block_size=block, device="cpu"),
                JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12), block_size=block))
    return (HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), block_size=block, device="cpu"),
            JHaarTrainEvaluator(jfeatures.haar_catalog(12, 12, "BASIC"), block_size=block))


def _assert_trees_equal(ours, theirs):
    assert ours.threshold == theirs.threshold
    assert len(ours.trees) == len(theirs.trees)
    for a, b in zip(ours.trees, theirs.trees):
        for f in ("left", "right", "feature_idx", "threshold", "subsets", "leaf_values"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("feature,boost_type", [("HAAR", "GAB"), ("HAAR", "DAB"),
                                                ("HAAR", "RAB"), ("HAAR", "LB"),
                                                ("LBP", "GAB")])
def test_stage_trainer_deep_matches_original(feature, boost_type, depth):
    """Mirrors tests/test_train.py::test_stage_trainer_depth2: the trees
    (pre-order nodes, DFS leaves, DAB's scaled leaves), the threshold and
    the per-sample sums, with the value blocks evicted for Haar (the
    generic path at the root as well)."""
    samples, labels, valid = _samples(pad=26)
    block = 256 if feature == "LBP" else 1024
    ev, jev = _evaluators(feature, block)
    ev.set_samples(samples)
    jev.set_samples(samples)
    val_mb = None if feature == "LBP" else 2.5 * 4 * len(samples) * block / 2**20
    params = boost.BoostParams(boost_type=BOOSTS[boost_type], max_depth=depth, weak_count=5,
                               max_false_alarm=0.05)
    s, sums = boost.StageTrainer(ev, params, val_buf_mb=val_mb).train(labels, valid=valid,
                                                                      verbose=False)
    js, jsums = jboost.StageTrainer(jev, jboost.BoostParams(**dataclasses.asdict(params)),
                                    val_buf_mb=val_mb).train(labels, valid=valid, verbose=False)
    _assert_trees_equal(s, js)
    np.testing.assert_array_equal(sums, jsums)
    assert max(t.num_nodes for t in s.trees) >= 2
    assert max(len(t.leaf_values) for t in s.trees) >= 3


def test_predict_tree_matches_original():
    """The per-sample leaf values of deep trees: JAX _predict_tree and the
    port's one-pass walk in node order."""
    samples, labels, valid = _samples()
    ev, jev = _evaluators("HAAR", 1024)
    ev.set_samples(samples)
    jev.set_samples(samples)
    params = boost.BoostParams(max_depth=3, weak_count=4, max_false_alarm=0.05)
    js, _ = jboost.StageTrainer(jev, jboost.BoostParams(**dataclasses.asdict(params))).train(
        labels, valid=valid, verbose=False)
    ours = boost.StageTrainer(ev, params)
    cache = boost.FeatureCache(ev)
    jtrainer = jboost.StageTrainer(jev, jboost.BoostParams(**dataclasses.asdict(params)))
    jtrainer.categorical = False
    jcache = jboost.FeatureCache(jev, False)
    for t, jt in zip(stages_from_jax([js])[0].trees, js.trees):
        got = ours._predict_tree(t, cache, len(samples))
        want = jtrainer._predict_tree(jt, jcache, len(samples))
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def _mixed_stages(feature, seed=0):
    """Three JAX-trained stages (global indices): stumps, depth 2, depth 3."""
    samples, labels, valid = _samples(seed=seed)
    _, jev = _evaluators(feature, 256 if feature == "LBP" else 1024)
    jev.set_samples(samples)
    stages = []
    for depth, lab, wc in ((1, labels, 3), (2, labels, 3), (3, 1 - labels, 2)):
        st, _ = jboost.StageTrainer(jev, jboost.BoostParams(max_depth=depth, weak_count=wc,
                                                            max_false_alarm=0.2)).train(
            lab, valid=valid, verbose=False)
        stages.append(st)
    stages[2].threshold = -0.5
    return stages


def _jax_evaluator(feature):
    if feature == "LBP":
        return JLBPTrainEvaluator(jfeatures.lbp_catalog(12, 12))
    return JHaarTrainEvaluator(jfeatures.haar_catalog(12, 12, "BASIC"))


@pytest.mark.parametrize("n_stages", [1, 2, 3])
@pytest.mark.parametrize("feature", ["HAAR", "LBP"])
def test_deep_predict_batch_matches_original(feature, n_stages):
    """Mixed stump and deep cascades: one stump stage takes stump_walk,
    any deep stage tree_walk; the masks equal JAX predict_batch's."""
    jstages = _mixed_stages(feature)[:n_stages]
    rng = np.random.default_rng(9)
    win = rng.integers(0, 200, (300, 12, 12)).astype(np.uint8)
    win[::3, 3:9, 3:9] = rng.integers(90, 170, (100, 6, 6))
    jp = JPredictor(lambda: _jax_evaluator(feature), jstages)
    ev, _ = _evaluators(feature, 1024)
    ours = CascadePredictor(lambda: ev, stages_from_jax(jstages))
    assert ours._all_stumps() == (n_stages == 1)
    got, want = ours.predict_batch(win), jp.predict_batch(win)
    assert 0 < got.sum() < len(win)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("feature", ["HAAR", "LBP"])
def test_deep_predict_levels_matches_original(feature):
    """The miner on a deep cascade: windows of whole levels through the
    evaluator and tree_walk, against the JAX package's gather path."""
    rng = np.random.default_rng(4)
    jstages = _mixed_stages(feature, seed=2)
    levels = []
    for h, w in ((40, 52), (31, 30), (24, 24)):
        img = rng.integers(0, 200, (h, w)).astype(np.uint8)
        img[5:20, 5:20] = 150
        ys, xs = np.meshgrid(np.arange(0, h - 11, 6), np.arange(0, w - 11, 6), indexing="ij")
        pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.int32)
        levels.append((img, pos[1:], (len(levels), 1.0)))
    jp = JPredictor(lambda: _jax_evaluator(feature), jstages)
    ev, _ = _evaluators(feature, 1024)
    ours = CascadePredictor(lambda: ev, stages_from_jax(jstages))
    got, want = ours.predict_levels(levels, 12, 12), jp.predict_levels(levels, 12, 12)
    assert 0 < np.concatenate(got).sum() < sum(len(g) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_tree_walk_sums_in_tree_order():
    """tree_walk's stage sums start from 0 and add each leaf in tree
    order; stump_walk's are differences of one prefix over every tree.
    Stage 0 holds a leaf of 2^54, stage 1 two leaves of 1: tree order
    sums stage 1 to 2 and accepts it at 1.5, the prefix loses both ones
    against 2^54 and rejects it."""
    big = float(2 ** 54)
    vals = torch.zeros((1, 1), dtype=torch.float32)
    leaves = torch.tensor([big, big, 1.0, 1.0, 1.0, 1.0], dtype=torch.float32)
    zeros3 = torch.zeros(3, dtype=torch.int64)
    ok = predictor.tree_walk(vals, zeros3, torch.zeros(3), None, torch.tensor([-1, -3, -5]),
                             torch.tensor([-2, -4, -6]), leaves, torch.tensor([0, 1, 2]), 1,
                             [0, 1, 3], [0.0, 1.5])
    assert bool(ok[0])
    ok_prefix = predictor.stump_walk(vals, zeros3, torch.zeros(3), torch.tensor([big, 1.0, 1.0]),
                                     torch.tensor([big, 1.0, 1.0]), None, torch.tensor([0, 1]),
                                     torch.tensor([1, 3]), torch.tensor([0.0, 1.5],
                                                                        dtype=torch.float64))
    assert not bool(ok_prefix[0])


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("run", ["HAAR-GAB", "HAAR-DAB", "HAAR-RAB", "HAAR-LB", "LBP-GAB"])
def test_deep_toy_run_matches_original(tmp_path, run, depth):
    """12x12 toy runs at max_depth 2 and 3: stage files, params,
    cascade.xml and the transcript equal the JAX trainer's; the miner walks
    deep trees from stage 1 on."""
    feature, bt = run.split("-")
    d = str(tmp_path)
    diag_data(d)
    params = boost.BoostParams(boost_type=BOOSTS[bt], max_depth=depth, max_false_alarm=0.05,
                               weak_count=4)
    ours, theirs = toy_both(d, {"HAAR": FEATURE_HAAR, "LBP": FEATURE_LBP}[feature], "BASIC",
                            params)
    assert_same_run(d, ours, theirs)
    model = ours[0]
    assert model.num_stages >= 2
    assert max(t.num_nodes for s in model.stages for t in s.trees) >= 2
