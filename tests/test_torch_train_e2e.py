"""The port's CascadeTrainer end to end against the JAX package's on the
CPU: a 12x12 two-stage toy run whose params.xml, stage*.xml, cascade.xml
and legacy cascade are byte-identical and whose transcript matches line
for line, and a trainer carried over from the JAX package.
tests/test_torch_train_resume.py resumes from checkpoints."""

import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.train.trainer import CascadeTrainer as JCascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.convert import trainer_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.data.vec import write_vec  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402

FILES = ("params.xml", "stage0.xml", "stage1.xml", "cascade.xml", "cascade_oldformat.xml")


def toy_data(d):
    """120 positives (a jittered grey square on noise) and one 120x160
    PGM background of noise with squares of every size at every 5 pixels:
    near-miss decoys, so that the second stage mines hard negatives."""
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 120, (120, 12, 12)).astype(np.uint8)
    pos[:, 3:9, 3:9] = rng.integers(100, 200, (120, 6, 6))
    write_vec(os.path.join(d, "pos.vec"), pos)
    h, w = 120, 160
    bg = rng.integers(0, 120, (h, w)).astype(np.uint8)
    for y0 in range(0, h - 8, 5):
        for x0 in range(0, w - 8, 5):
            sz = rng.integers(3, 9)
            bg[y0:y0 + sz, x0:x0 + sz] = rng.integers(100, 200, (sz, sz))
    with open(os.path.join(d, "bg.pgm"), "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h) + bg.tobytes())
    with open(os.path.join(d, "bg.txt"), "w") as f:
        f.write(os.path.join(d, "bg.pgm") + "\n")


def _run(trainer, d, out, num_stages=4):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model = trainer.train(os.path.join(d, out), os.path.join(d, "pos.vec"),
                              os.path.join(d, "bg.txt"), num_pos=100, num_neg=80,
                              num_stages=num_stages, base_format_save=True)
    lines = [ln for ln in buf.getvalue().splitlines() if not ln.startswith("Training until")]
    return model, lines


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("toy"))
    toy_data(d)
    ours = _run(CascadeTrainer(win_w=12, win_h=12, device="cpu"), d, "port")
    theirs = _run(JCascadeTrainer(win_w=12, win_h=12), d, "jax")
    return d, ours, theirs


@pytest.mark.parametrize("name", FILES)
def test_toy_run_writes_the_same_bytes(toy, name):
    d, _ours, _theirs = toy
    with open(os.path.join(d, "port", name), "rb") as a, open(os.path.join(d, "jax", name),
                                                              "rb") as b:
        assert a.read() == b.read()


def test_toy_run_transcript_and_model(toy):
    _d, (model, lines), (jmodel, jlines) = toy
    assert lines == jlines
    assert model.num_stages == jmodel.num_stages == 2
    assert sum(ln.startswith("|") for ln in lines) == 2 + sum(len(s.trees) for s in model.stages)
    assert "===== TRAINING 1-stage =====" in lines


def test_trainer_from_jax_predicts_and_writes_the_same(toy, tmp_path):
    d, _ours, _theirs = toy
    jt = JCascadeTrainer(win_w=12, win_h=12)
    assert jt.load(os.path.join(d, "jax"))
    ours = trainer_from_jax(jt, device="cpu")
    assert ours.boost.__dict__ == jt.boost.__dict__ and len(ours.stages) == 2
    rng = np.random.default_rng(0)
    win = rng.integers(0, 200, (200, 12, 12)).astype(np.uint8)
    np.testing.assert_array_equal(ours._predictor().predict_batch(win),
                                  jt._predictor().predict_batch(win))
    from cascadeclassifier_tpu.models.xml_io import write_cascade_xml as jwrite
    from cascadeclassifier_tpu_torch.models.xml_io import write_cascade_xml

    write_cascade_xml(ours._to_model(), str(tmp_path / "a.xml"))
    jwrite(jt._to_model(), str(tmp_path / "b.xml"))
    assert (tmp_path / "a.xml").read_bytes() == (tmp_path / "b.xml").read_bytes()
