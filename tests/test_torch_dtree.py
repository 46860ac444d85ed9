"""The standalone CART (train/dtree.py) in the port against the JAX
package on the CPU: the 12 scenarios of tests/test_dtree.py, each with its
own assertion on the port's tree and with the port's tree equal to the JAX
package's node for node (variables, thresholds, subsets, leaves, counts,
risks, surrogates) and its predictions equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.train import dtree as jdtree  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.train import dtree  # noqa: E402


def _assert_same_tree(a, b):
    assert a.is_leaf() == b.is_leaf()
    assert (a.leaf_value, a.n, a.risk) == (b.leaf_value, b.n, b.risk)
    if a.is_leaf():
        return
    assert (a.var, a.thr, a.default_left) == (b.var, b.thr, b.default_left)
    assert (a.subset is None) == (b.subset is None)
    if a.subset is not None:
        np.testing.assert_array_equal(np.asarray(a.subset, np.int64),
                                      np.asarray(b.subset, np.int64))
    assert len(a.surrogates) == len(b.surrogates)
    for sa, sb in zip(a.surrogates, b.surrogates):
        assert (sa[0], sa[1], sa[3]) == (sb[0], sb[1], sb[3])
        assert (sa[2] is None) == (sb[2] is None)
        if sa[2] is not None:
            np.testing.assert_array_equal(sa[2], sb[2])
    _assert_same_tree(a.left, b.left)
    _assert_same_tree(a.right, b.right)


def _both(params, x, y, regression=False, categorical=(), **fit):
    """The port's tree and the JAX package's, fitted on the same data;
    their trees and predictions on x equal."""
    ours = dtree.DecisionTree(params, regression=regression, categorical=categorical,
                              device="cpu").fit(x, y, **fit)
    theirs = jdtree.DecisionTree(
        jdtree.DTreeParams(**{k: getattr(params, k) for k in params.__dataclass_fields__}),
        regression=regression, categorical=categorical).fit(x, y, **fit)
    _assert_same_tree(ours.root, theirs.root)
    np.testing.assert_array_equal(ours.predict(x), theirs.predict(x))
    return ours, theirs


def test_separable_1d_classification():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (200, 1)).astype(np.float32)
    y = (x[:, 0] > 0.1).astype(np.float64)
    t, jt = _both(dtree.DTreeParams(cv_folds=0), x, y)
    assert (t.predict(x) == y).mean() == 1.0
    xt = rng.uniform(-1, 1, (100, 1)).astype(np.float32)
    yt = (xt[:, 0] > 0.1).astype(np.float64)
    assert (t.predict(xt) == yt).mean() > 0.95
    np.testing.assert_array_equal(t.predict(xt), jt.predict(xt))


def test_separable_2d_classification():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (400, 2)).astype(np.float32)
    y = ((x[:, 0] > 0) & (x[:, 1] > 0)).astype(np.float64)
    t, _ = _both(dtree.DTreeParams(cv_folds=0), x, y)
    assert (t.predict(x) == y).mean() > 0.99


def test_regression_mode():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 4, (300, 1)).astype(np.float32)
    y = np.floor(x[:, 0])
    t, _ = _both(dtree.DTreeParams(cv_folds=0, regression_accuracy=0.01), x, y,
                 regression=True)
    assert np.abs(t.predict(x) - y).mean() < 0.1


def test_cv_pruning_shrinks_noisy_tree():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    y = rng.integers(0, 2, 300).astype(np.float64)
    full, _ = _both(dtree.DTreeParams(cv_folds=0, min_sample_count=5), x, y)
    pruned, _ = _both(dtree.DTreeParams(cv_folds=10, min_sample_count=5, use_1se_rule=True),
                      x, y)
    assert pruned.num_leaves() <= full.num_leaves() // 3
    assert pruned.num_leaves() <= 16


def test_sample_idx_masking():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (200, 1)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float64)
    y2 = y.copy()
    y2[100:] = rng.integers(0, 2, 100)
    t, _ = _both(dtree.DTreeParams(cv_folds=0), x, y2, sample_idx=np.arange(100))
    assert (t.predict(x[:100]) == y2[:100]).mean() == 1.0


def test_categorical_split():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 8, 300)
    y = np.isin(codes, [1, 3, 5]).astype(np.float64)
    x = codes[:, None].astype(np.float32)
    t, _ = _both(dtree.DTreeParams(cv_folds=0), x, y, categorical=[0])
    assert (t.predict(x) == y).mean() == 1.0


def test_categorical_regression_split():
    """The categorical kernel's regression policy (no scenario of
    tests/test_dtree.py reaches it): per-code means, a mixed ordered and
    categorical table."""
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 40, 400)
    y = (codes % 5).astype(np.float64) + rng.normal(scale=0.05, size=400)
    x = np.stack([codes, rng.uniform(-1, 1, 400)], axis=1).astype(np.float32)
    t, _ = _both(dtree.DTreeParams(cv_folds=0, min_sample_count=5), x, y, regression=True,
                 categorical=[0])
    assert t.root.subset is not None and np.abs(t.predict(x) - y).mean() < 0.2


def test_priors_shift_decision():
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (400, 1)).astype(np.float32)
    y = (x[:, 0] > 0.9).astype(np.float64)
    heavy, _ = _both(dtree.DTreeParams(cv_folds=0, priors=np.array([1.0, 50.0])), x, y)
    assert (heavy.predict(x)[y == 1] == 1).all()


def test_predict_before_fit_raises():
    with pytest.raises(AssertionError):
        dtree.DecisionTree(device="cpu").predict(np.zeros((1, 1), np.float32))


def test_multiclass_classification():
    rng = np.random.default_rng(5)
    n = 300
    x = rng.normal(size=(n, 2)).astype(np.float32)
    y = np.zeros(n)
    x[100:200, 0] += 6
    y[100:200] = 1
    x[200:, 1] += 6
    y[200:] = 2
    t, _ = _both(dtree.DTreeParams(cv_folds=0, min_sample_count=5), x, y)
    assert (t.predict(x) == y).mean() > 0.97
    xt = np.array([[0, 0], [6, 0], [0, 6]], np.float32)
    assert list(t.predict(xt)) == [0.0, 1.0, 2.0]


def test_multiclass_categorical_clustering():
    rng = np.random.default_rng(6)
    n = 600
    cats = rng.integers(0, 60, n)
    y = cats % 3
    x = np.stack([cats, rng.normal(size=n)], axis=1).astype(np.float32)
    t, _ = _both(dtree.DTreeParams(cv_folds=0, min_sample_count=5, max_categories=10), x,
                 y.astype(np.float64), categorical=(0,))
    assert (t.predict(x) == y).mean() > 0.9


def test_surrogate_splits_missing_values():
    rng = np.random.default_rng(7)
    n = 400
    y = (np.arange(n) % 2).astype(np.float64)
    f0 = np.where(y == 1, 2.0, -2.0) + rng.normal(scale=0.3, size=n)
    f1 = f0 + rng.normal(scale=0.2, size=n)
    x = np.stack([f0, f1], axis=1).astype(np.float32)
    xm = x.copy()
    xm[rng.random(n) < 0.2, 0] = np.nan
    t, jt = _both(dtree.DTreeParams(cv_folds=0, min_sample_count=5, use_surrogates=True),
                  xm, y)
    xt = np.stack([np.full(50, np.nan), np.where(np.arange(50) % 2 == 1, 2.0, -2.0)],
                  axis=1).astype(np.float32)
    yt = (np.arange(50) % 2).astype(np.float64)
    assert (t.predict(xt) == yt).mean() > 0.95
    np.testing.assert_array_equal(t.predict(xt), jt.predict(xt))
    assert t.root.surrogates


def test_missing_values_regression():
    rng = np.random.default_rng(8)
    n = 300
    x = rng.uniform(-1, 1, n)
    y = np.where(x > 0, 5.0, -5.0) + rng.normal(scale=0.1, size=n)
    xx = np.stack([x, x + rng.normal(scale=0.05, size=n)], axis=1).astype(np.float32)
    xx[rng.random(n) < 0.15, 0] = np.nan
    t, _ = _both(dtree.DTreeParams(cv_folds=0, min_sample_count=10), xx, y, regression=True)
    pred = t.predict(np.array([[0.5, 0.5], [-0.5, -0.5]], np.float32))
    assert abs(pred[0] - 5.0) < 1.0 and abs(pred[1] + 5.0) < 1.0


def test_kernel_path_goes_through_the_split_wrappers(monkeypatch):
    """The clean binary case calls the ordered and categorical wrappers
    (their plain versions on the CPU: no launch)."""
    calls = []
    for name in ("split_scan_class_gather", "categorical_class_split"):
        real = getattr(dtree, name)
        monkeypatch.setattr(dtree, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    rng = np.random.default_rng(9)
    x = np.stack([rng.uniform(-1, 1, 200), rng.integers(0, 6, 200)], 1).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] == 2)).astype(np.float64)
    _both(dtree.DTreeParams(cv_folds=0), x, y, categorical=[1])
    assert {"split_scan_class_gather", "categorical_class_split"} <= set(calls)
    assert _build.LAUNCHES["split_scan_class_gather"] == _build.LAUNCHES["cat_split"] == 0


def test_cuda_tree_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        dtree.DecisionTree()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the split kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("regression", [False, True])
def test_tree_on_the_card_matches_the_cpu(cuda_device, regression):
    """The kernels on the card give the CPU's tree node for node (ordered
    and categorical columns, CV pruning)."""
    rng = np.random.default_rng(10)
    x = np.stack([rng.uniform(-1, 1, 500), rng.integers(0, 30, 500), rng.normal(size=500)],
                 1).astype(np.float32)
    y = ((x[:, 0] > 0.2) ^ (x[:, 1] % 3 == 0)).astype(np.float64)
    if regression:
        y = y * 3.0 + x[:, 2]
    params = dtree.DTreeParams(cv_folds=5, min_sample_count=5)
    before = _build.LAUNCHES["cat_split"]
    card = dtree.DecisionTree(params, regression=regression, categorical=[1],
                              device=cuda_device).fit(x, y)
    host = dtree.DecisionTree(params, regression=regression, categorical=[1],
                              device="cpu").fit(x, y)
    assert _build.LAUNCHES["cat_split"] > before
    _assert_same_tree(card.root, host.root)
