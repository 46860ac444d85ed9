"""Each cell's check on the CPU at a size a test run holds: a sound run
of the program comes out correct; the lower-precision controls, and a
run with the program broken underneath (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced), come out not correct. The harness's look for a card is
skipped: the drivers run on the CPU here. One card, so no exchange
between cards to leave out."""

import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark import control, manifest
from benchmark.drivers import detect, train

SEED = 2**31 + 4321


def _log(*a):
    print(*a, file=sys.stderr)


@pytest.fixture
def video_spec():
    spec = manifest.cell(manifest.load(), "frontal_alt.video2160")
    spec["traffic"].update(pool=2, faces=6, base_width=320, base_height=180, upscale=2,
                           face_size=[15, 40])
    return spec


@pytest.fixture
def train_spec():
    spec = manifest.cell(manifest.load(), "haar24_gab.early_stages")
    spec["config"].update(w=12, h=12, numPos=200, numNeg=300, numStages=3, maxWeakCount=6)
    spec["traffic"].update(vec_count=260, backgrounds=4, bg_height=90, bg_width=160, corpora=2)
    return spec


def _run(driver, spec):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return driver.run(spec, seed=SEED, seconds=0.5, trace=False, t0=time.perf_counter(),
                      log=_log, device="cpu")


# -------------------------------------------------------------- detection


def test_detection_sound_run_is_correct(video_spec):
    r = _run(detect, video_spec)
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] >= 1


def _altered(orig):
    def detect_(self, img, plan, timings=None):
        idx = orig(self, img, plan, timings)
        return np.concatenate([idx[:-1], idx[-1:] + 1]) if len(idx) else idx
    return detect_


def _halved(orig):
    def detect_(self, img, plan, timings=None):
        idx = orig(self, img, plan, timings)
        return idx[: len(idx) // 2]
    return detect_


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_detection_fault_is_caught(video_spec, monkeypatch, fault):
    from cascadeclassifier_tpu_torch.detect import engine

    if fault == "unchanged":  # the front hands its input mask back
        monkeypatch.setattr(engine, "front", lambda s, inv, alive, *a, **k: alive)
    else:
        wrap = _halved if fault == "half" else _altered
        monkeypatch.setattr(engine.Engine, "detect", wrap(engine.Engine.detect))
    r = _run(detect, video_spec)
    assert not r["correct"]


def test_detection_controls(video_spec):
    """The readings ``benchmark.control`` takes on the card, here at the
    test's size, on scenes drawn from the seed: the program reads 0; the
    bf16 control fails. (The f32-sum readings are taken, not judged: f32
    stage sums flip only windows whose sum lies within f32 rounding of a
    stage threshold, which the cell's frames seldom hold.)"""
    args = types.SimpleNamespace(seeds=[SEED], control_seeds=[SEED], device="cpu")
    got = {what: reading() for what, _, reading in control.detect_runs(video_spec, args)}
    assert got["program"]["raw_mismatch"] == 0 and got["program"]["rect_mismatch"] == 0
    assert got["reference_bf16"]["raw_mismatch"] > video_spec["cell"]["limits"]["raw_mismatch"]
    assert {"program_f32", "reference_f32"} <= set(got)


# --------------------------------------------------------------- training


def test_training_sound_run_is_correct(train_spec):
    r = _run(train, train_spec)
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "stage_cut", "job_cut",
                                   "threshold"])
def test_training_fault_is_caught(train_spec, monkeypatch, fault):
    from cascadeclassifier_tpu_torch.train import boost, trainer

    if fault == "unchanged":  # a tree that moves no weight and no stage sum
        monkeypatch.setattr(boost.StageTrainer, "_predict_tree",
                            lambda self, tree, cache, n: np.zeros(n, np.float64))
    elif fault == "half":  # the split search sees every other sample
        orig = boost.StageTrainer._find_best_split

        def half(self, cache, w, resp, mask):
            return orig(self, cache, w, resp, mask & (np.arange(len(mask)) % 2 == 0))
        monkeypatch.setattr(boost.StageTrainer, "_find_best_split", half)
    elif fault == "altered":  # a leaf altered where it is made
        orig = boost.StageTrainer._node_value
        monkeypatch.setattr(boost.StageTrainer, "_node_value",
                            lambda self, *a: np.float32(orig(self, *a) * np.float32(1.0001)))
    elif fault == "stage_cut":  # every stage ends after its first tree
        orig = boost.StageTrainer._train_tree

        def first_only(self, *a):
            if getattr(self, "_grown", False):
                return None, None
            self._grown = True
            return orig(self, *a)
        monkeypatch.setattr(boost.StageTrainer, "_train_tree", first_only)
    elif fault == "job_cut":  # the job ends after its first stage
        orig = trainer.CascadeTrainer.train

        def one_stage(self, data_dir, vec, bg, num_pos, num_neg, num_stages=20, **k):
            return orig(self, data_dir, vec, bg, num_pos, num_neg, min(num_stages, 1), **k)
        monkeypatch.setattr(trainer.CascadeTrainer, "train", one_stage)
    else:  # each stage's threshold written less the runtime's margin
        orig = boost.StageTrainer.train

        def lowered(self, *a, **k):
            stage, sums = orig(self, *a, **k)
            if stage is not None:
                stage.threshold -= 1e-5
            return stage, sums
        monkeypatch.setattr(boost.StageTrainer, "train", lowered)
    r = _run(train, train_spec)
    assert not r["correct"]
    if fault in ("stage_cut", "job_cut"):
        assert r["checks"][-1]["name"] == "stop_mismatch" and r["checks"][-1]["value"] > 0
    if fault == "threshold":
        assert r["checks"][2]["name"] == "threshold_gap"
        assert r["checks"][2]["value"] > r["checks"][2]["limit"]


def test_training_controls(train_spec):
    """The readings ``benchmark.control`` takes on the card, here at the
    test's size: the program and the reference's own f64 cascade (the
    same trees as the program's) read within the limits, the f32 control
    and every planted fault do not."""
    args = types.SimpleNamespace(seeds=[SEED], control_seeds=[SEED], faults=True, device="cpu")
    lim = train_spec["cell"]["limits"]
    for what, _, reading in control.train_runs(train_spec, args):
        r = reading()
        ok = all(r[k] <= v for k, v in lim.items())
        assert ok == (what in ("program", "reference_f64")), (what, r)
        if what == "reference_f64":
            assert r["trees_differing_from_program"] == 0
