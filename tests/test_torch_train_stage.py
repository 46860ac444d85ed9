"""The port's stage trainer against the JAX package on the CPU: a GAB
stage (trees, thresholds, leaves, the stage threshold and the per-sample
sums) with no budgets and with budgets that evict value and index blocks,
and the options the trainer takes (a mesh: tests/test_torch_parallel.py).
tests/test_torch_train_predictor.py holds the mining predictor, and
tests/test_torch_train_boost_types.py the other boost types."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.ops.features import haar_catalog as jhaar_catalog  # noqa: E402
from cascadeclassifier_tpu.train.boost import BoostParams as JBoostParams  # noqa: E402
from cascadeclassifier_tpu.train.boost import StageTrainer as JStageTrainer  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import (  # noqa: E402
    BOOST_DAB,
    BOOST_LB,
    BOOST_RAB,
    FEATURE_HOG,
    FEATURE_LBP,
)
from cascadeclassifier_tpu_torch.ops.features import haar_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.parallel.sharded import make_mesh  # noqa: E402
from cascadeclassifier_tpu_torch.train import boost  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402


def _samples(n_pos=60, n_neg=70, w=12, h=12, seed=0, pad=0):
    """Positives: a mid-grey square on darker noise; negatives: noise with
    squares of every size (near misses); pad zero windows at the end."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 140, (n_pos, h, w)).astype(np.uint8)
    for i in range(n_pos):  # a 6x6 square, jittered by a pixel
        y, x = 3 + rng.integers(-1, 2), 3 + rng.integers(-1, 2)
        pos[i, y:y + 6, x:x + 6] = rng.integers(90, 170, (6, 6))
    neg = rng.integers(0, 140, (n_neg, h, w)).astype(np.uint8)
    for i in range(n_neg):
        s, y, x = rng.integers(3, 9), rng.integers(0, 5), rng.integers(0, 5)
        neg[i, y:y + s, x:x + s] = rng.integers(90, 170, (s, s))
    samples = np.concatenate([pos, neg, np.zeros((pad, h, w), np.uint8)])
    labels = np.concatenate([np.ones(n_pos, np.int32), np.zeros(n_neg + pad, np.int32)])
    valid = np.arange(len(samples)) < n_pos + n_neg
    return samples, labels, valid


def _assert_stages_equal(ours, theirs):
    assert ours.threshold == theirs.threshold
    assert len(ours.trees) == len(theirs.trees)
    for a, b in zip(ours.trees, theirs.trees):
        for f in ("left", "right", "feature_idx", "threshold", "leaf_values"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _train_both(samples, labels, valid, params, block, val_mb, idx_mb, seed_mode="BASIC"):
    ev = HaarTrainEvaluator(haar_catalog(12, 12, seed_mode), block_size=block, device="cpu")
    jev = JHaarTrainEvaluator(jhaar_catalog(12, 12, seed_mode), block_size=block)
    ev.set_samples(samples)
    jev.set_samples(samples)
    ours = boost.StageTrainer(ev, params, val_buf_mb=val_mb, idx_buf_mb=idx_mb)
    theirs = JStageTrainer(jev, JBoostParams(**dataclasses.asdict(params)),
                           val_buf_mb=val_mb, idx_buf_mb=idx_mb)
    s, sums = ours.train(labels, valid=valid, verbose=False)
    js, jsums = theirs.train(labels, valid=valid, verbose=False)
    return ev, (s, sums), (js, jsums)


@pytest.mark.parametrize("budget", ["none", "evict", "evict_all"])
def test_stage_trainer_matches_original(budget):
    """Budgets None (every block resident and sorted: the fast path),
    budgets that keep 2 value blocks and 1 index block of 11 (both paths
    and recomputed blocks), and budgets that keep nothing (the CLI
    defaults' regime at full width: every block generic)."""
    samples, labels, valid = _samples(pad=26)
    n = len(samples)
    block = 1024
    per_val, per_idx = 4 * n * block / 2**20, 17 * n * block / 2**20
    val_mb, idx_mb = {"none": (None, None), "evict": (2.5 * per_val, 1.5 * per_idx),
                      "evict_all": (0.5 * per_val, 0.5 * per_idx)}[budget]
    params = boost.BoostParams(weak_count=12, max_false_alarm=0.05)
    ev, (s, sums), (js, jsums) = _train_both(samples, labels, valid, params, block, val_mb, idx_mb)
    cache = boost.FeatureCache(ev, val_mb, idx_mb)
    assert cache.num_blocks == 11
    assert (cache.n_val, cache.n_idx) == {"none": (11, 11), "evict": (2, 1),
                                          "evict_all": (0, 0)}[budget]
    assert len(s.trees) >= 3
    _assert_stages_equal(s, js)
    np.testing.assert_array_equal(sums, jsums)


def test_stage_trainer_all_mode_matches_original():
    """Haar ALL (tilted features in the product) with a tie-heavy sample set."""
    samples, labels, valid = _samples(n_pos=30, n_neg=40, seed=4)
    samples[::3] //= 16  # flat, low-contrast windows: many equal values
    params = boost.BoostParams(weak_count=5)
    _ev, (s, sums), (js, jsums) = _train_both(samples, labels, valid, params, 4096, None, None,
                                              "ALL")
    _assert_stages_equal(s, js)
    np.testing.assert_array_equal(sums, jsums)


def test_split_calls_go_through_the_wrapper_once_per_block(monkeypatch):
    samples, labels, valid = _samples()
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), block_size=2048, device="cpu")
    ev.set_samples(samples)
    calls = []
    real = boost.split_scan_gather

    def spy(*args):
        calls.append((args[0].shape, args[2].shape))
        return real(*args)

    monkeypatch.setattr(boost, "split_scan_gather", spy)
    stage, _ = boost.StageTrainer(ev, boost.BoostParams(weak_count=3)).train(
        labels, valid=valid, verbose=False)
    nb = ev.num_blocks()
    assert len(calls) == nb * len(stage.trees)
    # (N, B) blocks and per-sample tables: no (N, B) f64 input is built
    assert all(c[0][0] == len(samples) and c[1] == (len(samples),) for c in calls)
    assert _build.LAUNCHES["split_scan_gather"] == 0  # the CPU takes the plain version
    assert _build.LAUNCHES["split_scan"] == 0


@pytest.mark.parametrize("what", ["DAB", "RAB", "LB", "depth2", "mesh", "LBP", "HOG"])
def test_unported_options_raise(what):
    """Every option builds: DAB, RAB, LB, LBP, deep trees, HOG and a
    FeatureMesh; a mesh of another type raises TypeError."""
    kw = {"DAB": dict(boost=boost.BoostParams(boost_type=BOOST_DAB)),
          "RAB": dict(boost=boost.BoostParams(boost_type=BOOST_RAB)),
          "LB": dict(boost=boost.BoostParams(boost_type=BOOST_LB)),
          "depth2": dict(boost=boost.BoostParams(max_depth=2)),
          "mesh": dict(mesh=make_mesh(2, devices=["cpu"] * 2)),
          "LBP": dict(feature_type=FEATURE_LBP),
          "HOG": dict(feature_type=FEATURE_HOG)}[what]
    trainer = CascadeTrainer(device="cpu", **kw)
    assert trainer.evaluator.maxCatCount == (256 if what == "LBP" else 0)
    if what == "mesh":
        assert trainer.mesh.shape == {"feat": 2}
        with pytest.raises(TypeError):
            CascadeTrainer(device="cpu", mesh=object())


def test_cuda_trainer_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeTrainer()


@pytest.mark.parametrize("trim", [False, True])
def test_fast_and_generic_split_inputs_agree(trim):
    """At a tree root (mask = valid & (w >= wthr)) both callers hand the
    split kernel the same block, sample-major, contiguous and typed as the
    kernel takes it."""
    samples, labels, valid = _samples(pad=26)
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), block_size=2048, device="cpu")
    ev.set_samples(samples)
    cache = boost.FeatureCache(ev)
    resp = (labels * 2 - 1).astype(np.float64)
    cache.set_stage(valid, resp)
    w = np.where(valid, np.random.default_rng(0).random(len(valid)), 0.0)
    wthr = float(np.quantile(w[valid], 0.4)) if trim else -np.inf
    mask = valid & (w >= wthr)
    w_dev, r_dev, m_dev = (torch.as_tensor(a) for a in (w, resp, mask))
    for b in range(cache.num_blocks):
        fast = boost.fast_inputs(cache, b, w_dev, wthr)
        gen = boost.generic_inputs(cache, b, w_dev, r_dev, m_dev)
        for x, y, dtype in zip(fast, gen, (torch.float32, torch.float64, torch.float64,
                                           torch.bool)):
            assert torch.equal(x, y) and x.is_contiguous() and y.is_contiguous()
            assert x.dtype == dtype and x.shape == (len(valid), ev.block_slice(b)[1] - b * 2048)
