"""The port's mining predictor against the JAX package on the CPU: accept
masks on sample batches and on lazy and eager mining levels, and the
trainer's dense negative fill (selection, consumption, reader position).
The reader's levels come as GridRuns: their positions equal the JAX
reader's arrays byte for byte, and the predictor builds none of them."""

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
from cascadeclassifier_tpu_torch.data.negreader import GridRun, NegReader  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import haar_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator  # noqa: E402
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.utils import train_data  # noqa: E402

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


def _pgm_backgrounds(tmp_path, sizes):
    names = []
    for k, (h, w) in enumerate(sizes):
        names.append(str(tmp_path / f"bg{k}.pgm"))
        train_data.write_pgm(names[-1], np.random.default_rng(20 + k).integers(
            0, 256, (h, w)).astype(np.uint8))
    bg = tmp_path / "bg.txt"
    bg.write_text("\n".join(names) + "\n")
    return str(bg)


@pytest.mark.parametrize("side", [12, 24])
def test_grid_run_positions_equal_original(tmp_path, side):
    """level_positions' GridRun equals the JAX reader's positions byte for
    byte (dtype, shape, bytes) over 30 levels, partial first rows and
    states after skip among them; len, elements and slices agree without
    or with the array built."""
    bg = _pgm_backgrounds(tmp_path, ((70, 95), (131, 60), (48, 200)))
    ours, theirs = NegReader(bg, side, side, lazy=True), JNegReader(bg, side, side, lazy=True)
    partial = 0
    for i in range(30):
        (_img, pos), (_jimg, jpos) = ours.level_positions(), theirs.level_positions()
        assert isinstance(pos, GridRun) and len(pos) == len(jpos)
        partial += pos.first % pos.nx != 0
        for k in (0, len(jpos) // 2, len(jpos) - 1, -1):
            if len(jpos):
                assert pos[k, 0] == jpos[k, 0] and pos[k, 1] == jpos[k, 1]
                assert pos[k, -1] == jpos[k, -1] and isinstance(pos[k, 0], np.int32)
        assert not pos.materialized
        arr = np.asarray(pos)
        assert arr.dtype == jpos.dtype and arr.shape == jpos.shape
        assert arr.tobytes() == jpos.tobytes()
        np.testing.assert_array_equal(pos[1::3], jpos[1::3])
        step = [len(jpos), max(len(jpos) - 3, 0), len(jpos) // 2 + 1, 1][i % 4]
        assert ours.skip(step) == theirs.skip(step)
        assert ours.point == theirs.point
    assert partial >= 5


def test_predict_levels_builds_no_positions_without_accepts(tmp_path):
    """The dense miner on the CPU reads a GridRun's fields only: a cascade
    that accepts no window leaves every level's positions unbuilt."""
    bg = _pgm_backgrounds(tmp_path, ((70, 95), (131, 60)))
    rd = NegReader(bg, 12, 12, lazy=True)
    levels = []
    for _ in range(12):
        img, pos = rd.level_positions()
        levels.append((img, pos, (rd.last, float(rd.scale))))
        rd.skip(len(pos))
    stages = stages_from_jax(_stages())
    stages[0].threshold = 1e30  # rejects every window
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), device="cpu")
    got = CascadePredictor(lambda: ev, stages).predict_levels(levels, 12, 12)
    assert [len(g) for g in got] == [len(lv[1]) for lv in levels] and sum(map(len, got)) > 100
    assert not any(g.any() for g in got)
    assert not any(lv[1].materialized for lv in levels)
