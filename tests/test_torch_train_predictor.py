"""The port's mining predictor against the JAX package on the CPU: accept
masks on sample batches and on lazy and eager mining levels, and the
trainer's dense negative fill (selection, consumption, reader position)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.data.negreader import NegReader as JNegReader  # noqa: E402
from cascadeclassifier_tpu.ops.features import haar_catalog as jhaar_catalog  # noqa: E402
from cascadeclassifier_tpu.train.boost import BoostParams as JBoostParams  # noqa: E402
from cascadeclassifier_tpu.train.boost import StageTrainer as JStageTrainer  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu.train.predictor import CascadePredictor as JPredictor  # noqa: E402
from cascadeclassifier_tpu.train.trainer import CascadeTrainer as JCascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.convert import stages_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.data.negreader import NegReader  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import haar_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator  # noqa: E402
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402

from .test_torch_train_stage import _samples  # noqa: E402


def _stages(seed=0):
    """Two trained stages (global indices) from the JAX package."""
    samples, labels, valid = _samples(seed=seed)
    jev = JHaarTrainEvaluator(jhaar_catalog(12, 12, "BASIC"), block_size=4096)
    jev.set_samples(samples)
    st0, _ = JStageTrainer(jev, JBoostParams(weak_count=4, max_false_alarm=0.2)).train(
        labels, valid=valid, verbose=False)
    st1, _ = JStageTrainer(jev, JBoostParams(weak_count=3)).train(
        1 - labels, valid=valid, verbose=False)
    st1.threshold = -1.5
    return [st0, st1]


@pytest.mark.parametrize("n_stages", [1, 2])
def test_predict_batch_matches_original(n_stages):
    jstages = _stages()[:n_stages]
    rng = np.random.default_rng(9)
    win = rng.integers(0, 200, (300, 12, 12)).astype(np.uint8)
    win[::4, 3:9, 3:9] = 180
    jp = JPredictor(lambda: JHaarTrainEvaluator(jhaar_catalog(12, 12, "BASIC")), jstages)
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), device="cpu")
    ours = CascadePredictor(lambda: ev, stages_from_jax(jstages))
    got, want = ours.predict_batch(win), jp.predict_batch(win)
    assert 0 < got.sum() < len(win)
    np.testing.assert_array_equal(got, want)
    assert CascadePredictor(lambda: ev, []).predict_batch(win).all()


@pytest.mark.parametrize("lazy", [False, True])
def test_predict_levels_matches_original(tmp_path, lazy):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
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
    jstages = _stages(seed=1)
    ours_reader, their_reader = NegReader(bg, 12, 12, lazy=lazy), JNegReader(bg, 12, 12, lazy=lazy)
    levels, jlevels = [], []
    for _ in range(25):
        for rd, out in ((ours_reader, levels), (their_reader, jlevels)):
            img, pos = rd.level_positions()
            out.append((img, pos, (rd.last, float(rd.scale))))
            rd.skip(len(pos) - 1 if len(out) % 3 == 0 else len(pos))  # partial levels too
    jp = JPredictor(lambda: JHaarTrainEvaluator(jhaar_catalog(12, 12, "BASIC")), jstages)
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), device="cpu")
    ours = CascadePredictor(lambda: ev, stages_from_jax(jstages))
    got, want = ours.predict_levels(levels, 12, 12), jp.predict_levels(jlevels, 12, 12)
    assert [len(g) for g in got] == [len(lv[1]) for lv in levels]
    flat = np.concatenate(got)
    assert 0 < flat.sum() < len(flat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fill_negatives_matches_original(tmp_path):
    """The dense negative fill selects the same windows, consumes the same
    count and leaves the reader where the JAX trainer's does."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    names = []
    for i, (h, w) in enumerate(((80, 100), (64, 72))):
        p = str(tmp_path / f"bg{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (h, w)).astype(np.uint8))
        names.append(p)
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    jstages = _stages(seed=2)[:1]
    jstages[0].threshold = -1.0  # accepts about one window in 15
    jt = JCascadeTrainer(win_w=12, win_h=12, mining_batch=500)
    jt.stages = jstages
    ours = CascadeTrainer(win_w=12, win_h=12, mining_batch=500, device="cpu")
    ours.stages = stages_from_jax(jstages)
    out = []
    for tr, reader in ((ours, NegReader(bg, 12, 12, lazy=True)),
                       (jt, JNegReader(bg, 12, 12, lazy=True))):
        cc = [0]
        kept = tr._fill_negatives(reader, 60, 0.0, cc)
        out.append((kept, cc[0], reader.take_batch(5)))
    assert out[0][1] > 60
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][2], out[1][2])


