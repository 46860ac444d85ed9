"""The kernels of a sharded stage on the card against their plain versions
on the CPU (no JAX here: tests/test_torch_parallel.py holds the port
against the JAX package). Skips without a CUDA device; on the card:
``python3 -m pytest tests/test_torch_sharded_cuda.py -m cuda -q``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import BOOST_DAB  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import (  # noqa: E402
    haar_catalog,
    hog_catalog,
    lbp_catalog,
)
from cascadeclassifier_tpu_torch.parallel.dryrun import split_problem  # noqa: E402
from cascadeclassifier_tpu_torch.parallel.sharded import (  # noqa: E402
    make_mesh,
    shard_features,
    sharded_ordered_best_split,
)
from cascadeclassifier_tpu_torch.train import boost  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator,
    HOGTrainEvaluator,
    LBPTrainEvaluator,
)

KINDS = {  # kind: (evaluator class, catalog, window, block size, params, its split kernel)
    "Haar GAB": (HaarTrainEvaluator, lambda w: haar_catalog(w, w, "BASIC"), 10, 1024,
                 boost.BoostParams(weak_count=3), "split_scan_gather"),
    "Haar DAB depth 2": (HaarTrainEvaluator, lambda w: haar_catalog(w, w, "BASIC"), 10, 1024,
                         boost.BoostParams(boost_type=BOOST_DAB, max_depth=2, weak_count=3),
                         "split_scan_class_gather"),
    "LBP GAB": (LBPTrainEvaluator, lambda w: lbp_catalog(w, w), 12, 100,
                boost.BoostParams(weak_count=3), "cat_split"),
    "HOG": (HOGTrainEvaluator, lambda w: hog_catalog(w, w), 32, 252,
            boost.BoostParams(weak_count=3), "split_scan_gather"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _stage(kind, device, shards):
    evaluator, catalog, win, block, params, _kernel = KINDS[kind]
    rng = np.random.default_rng(3)
    labels = (np.arange(64) % 2).astype(np.int32)
    samples = rng.integers(0, 256, (64, win, win)).astype(np.uint8)
    blob = samples[labels == 1, win // 4:3 * win // 4, win // 4:3 * win // 4]
    samples[labels == 1, win // 4:3 * win // 4, win // 4:3 * win // 4] = blob // 2 + 60
    ev = evaluator(catalog(win), block_size=block, device=device)
    ev.set_samples(samples)
    mesh = make_mesh(shards, devices=[device] * shards)
    return boost.StageTrainer(ev, params, mesh=mesh).train(labels, verbose=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_stage_kernels_match_plain(cuda_device, kind):
    """A stage over 3 shards on cuda:0 (the split kernels, and HOG's
    hog_hist and hog_eval) equals the same stage over 3 CPU shards (their
    plain versions) bit for bit; each shard launched its split kernel."""
    _build.LAUNCHES.clear()
    card, card_sums = _stage(kind, cuda_device, 3)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES[KINDS[kind][5]]
    cpu, cpu_sums = _stage(kind, "cpu", 3)
    assert card.threshold == cpu.threshold and len(card.trees) == len(cpu.trees)
    for a, b in zip(card.trees, cpu.trees):
        for f in ("left", "right", "feature_idx", "threshold", "subsets", "leaf_values"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(card_sums, cpu_sums)
    assert launches >= 3 * len(card.trees)


@pytest.mark.cuda
def test_sharded_split_on_the_card_matches_plain(cuda_device):
    values, sort_idx, w, resp, mask = split_problem()
    answers = []
    for device in (cuda_device, "cpu"):
        mesh = make_mesh(3, devices=[device] * 3)
        vs, si = shard_features(mesh, values, sort_idx)
        answers.append(sharded_ordered_best_split(mesh)(vs, si, w, resp, mask))
    assert answers[0] == answers[1]
