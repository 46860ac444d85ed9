"""Resuming the port's CascadeTrainer from checkpoints, against the JAX
package on the CPU: from a params.xml + stage0.xml pair (both trainers
train stage 1 from a fresh reader to the same bytes) and from the
reference trainer's LBP checkpoint (tests/golden/ref_checkpoint)."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.train.trainer import CascadeTrainer as JCascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import FEATURE_LBP  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402

from .test_torch_train_e2e import _run, toy_data  # noqa: E402

REF_CHECKPOINT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                              "ref_checkpoint")


@pytest.fixture(scope="module")
def toy_stage0(tmp_path_factory):
    """The toy data and a one-stage port run's checkpoint."""
    d = str(tmp_path_factory.mktemp("toy_resume"))
    toy_data(d)
    _run(CascadeTrainer(win_w=12, win_h=12, device="cpu"), d, "port", 1)
    return d


def test_resume_from_a_checkpoint_matches_original(toy_stage0):
    """params.xml + stage0.xml only: both trainers load stage 0 and train
    stage 1 from a fresh reader (a lower leaf false-alarm target, so that
    mining from the schedule's start goes on); byte-identical results."""
    d = toy_stage0
    for who in ("port_resume", "jax_resume"):
        os.makedirs(os.path.join(d, who), exist_ok=True)
        for name in ("params.xml", "stage0.xml"):
            shutil.copy(os.path.join(d, "port", name), os.path.join(d, who, name))
    ours, lines = _run(CascadeTrainer(win_w=12, win_h=12, device="cpu"), d, "port_resume", 8)
    theirs, jlines = _run(JCascadeTrainer(win_w=12, win_h=12), d, "jax_resume", 8)
    assert lines[0] == "Training parameters are pre-loaded from the parameter file in data folder!"
    assert lines == jlines
    assert ours.num_stages >= 2
    for name in ("stage1.xml", "cascade.xml"):
        with open(os.path.join(d, "port_resume", name), "rb") as a, \
                open(os.path.join(d, "jax_resume", name), "rb") as b:
            assert a.read() == b.read()


def test_resume_from_reference_checkpoint():
    """The reference trainer's LBP checkpoint loads to the JAX package's
    stages; training on from it gets past the support checks (LBP training
    is ported) to the sample files, where both trainers stop alike."""
    ours, theirs = CascadeTrainer(device="cpu"), JCascadeTrainer()
    assert ours.load(REF_CHECKPOINT) and theirs.load(REF_CHECKPOINT)
    assert ours.feature_type == theirs.feature_type == FEATURE_LBP
    assert (ours.win_w, ours.win_h) == (theirs.win_w, theirs.win_h) == (75, 32)
    assert ours.boost.__dict__ == theirs.boost.__dict__
    assert len(ours.stages) == len(theirs.stages) == 2
    assert ours.stages[0].trees[0].feature_idx[0] == 1109
    for a, b in zip(ours.stages, theirs.stages):
        assert a.threshold == b.threshold and len(a.trees) == len(b.trees)
        for ta, tb in zip(a.trees, b.trees):
            for f in ("left", "right", "feature_idx", "subsets", "leaf_values"):
                np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
    for trainer in (ours, theirs):
        with pytest.raises(FileNotFoundError, match="unused.vec"):
            trainer.train(REF_CHECKPOINT, "unused.vec", "unused.txt", 10, 10, num_stages=3)
    assert not CascadeTrainer(device="cpu").load(os.path.dirname(REF_CHECKPOINT))


