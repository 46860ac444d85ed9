"""The port's tracer (utils/profiling.py) on the CPU: spans and counts
record only while a torch profiler is active, nothing synchronizes the
card off the timed scopes and the timings= path, nested spans reach the
Chrome trace with their ids, and a frontal frame counts its host waits."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu_torch.detect.detector import TorchDetector  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.utils import profiling  # noqa: E402

from .test_torch_train_e2e import toy_data  # noqa: E402
from .utils_synth import face_blob_image  # noqa: E402

FRONTAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "cascadeclassifier_tpu_torch", "data", "haarcascade_frontalface_alt.xml")
TIMED = {"fill_positives", "fill_negatives", "set_samples", "train_stage"}


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def clean():
    profiling.reset()
    profiling.reset_timings()
    yield
    profiling.reset()
    profiling.reset_timings()


@pytest.fixture
def syncs(monkeypatch):
    """A card that looks initialised, whose synchronize calls are counted."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(1))
    return calls


@pytest.fixture(scope="module")
def frontal():
    det = TorchDetector(read_cascade_xml(FRONTAL), device="cpu", impl="ref")
    img = face_blob_image(200, 150, n=4, seed=7)
    det.detect_multi_scale(img, 1.2, 3)  # every plan table built
    return det, img


def test_span_and_count_off_record_nothing(clean, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert profiling.span("a.b") is profiling.span("c.d")  # one shared null context
    with profiling.span("a.b") as s:
        with profiling.span("a.c"):
            profiling.count(profiling.SYNC)
            profiling.count("other", 4)
    assert s is None
    assert profiling.spans() == [] and profiling.counters() == {}


def test_nothing_synchronizes_off_the_timed_scopes(clean, syncs, tmp_path, frontal):
    """With tracing off, a toy training job (fills, the miner's
    mine.gather/predict/values/fetch, precalculation, split searches)
    synchronizes only at the two ends of each timed scope, and detection
    only with a timings dict, once a phase."""
    d = str(tmp_path)
    toy_data(d)
    CascadeTrainer(win_w=12, win_h=12, device="cpu").train(
        os.path.join(d, "out"), os.path.join(d, "pos.vec"), os.path.join(d, "bg.txt"),
        num_pos=100, num_neg=80, num_stages=2, verbose=False)
    tm = profiling.timings()
    assert set(tm) == TIMED and len(tm["train_stage"]) >= 1
    assert len(syncs) == 2 * sum(len(v) for v in tm.values())
    det, img = frontal
    del syncs[:]
    det.detect_multi_scale(img, 1.2, 3)
    assert syncs == []
    phases = {}
    det.raw_windows(img, 1.2, timings=phases)
    assert len(syncs) == len(phases) == 7


def test_a_traced_job_is_one_root(clean, tmp_path):
    """A toy job under the profiler: every span under its train.job root,
    the trainer's, the miner's and the stage trainer's spans among them,
    and the root holding every sync counted."""
    d = str(tmp_path)
    toy_data(d)
    with _profiled():
        CascadeTrainer(win_w=12, win_h=12, device="cpu").train(
            os.path.join(d, "out"), os.path.join(d, "pos.vec"), os.path.join(d, "bg.txt"),
            num_pos=100, num_neg=80, num_stages=2, verbose=False)
    s = profiling.spans()
    job = s[0]
    assert job.name == "train.job" and all(x.root == job.id for x in s)
    assert {"train.open", "train.stage", "train.save", "train.fill_positives",
            "train.fill_negatives", "train.set_samples", "train.train_stage", "mine.gather",
            "mine.predict", "mine.values", "mine.fetch", "boost.precalc", "boost.tree",
            "boost.split"} <= {x.name for x in s}
    precalc = [x for x in s if x.name == "boost.precalc"]
    assert len(precalc) == len(profiling.timings()["train_stage"]) >= 1
    assert job.counts["sync"] == profiling.counters()["sync"] > 0


def test_nested_spans_carry_ids_and_reach_the_chrome_trace(clean, tmp_path):
    log = str(tmp_path / "trace")
    with profiling.trace(log):
        for _ in range(2):
            with profiling.span("t.frame"):
                with profiling.span("t.phase"):
                    with profiling.span("t.inner"):
                        profiling.count(profiling.SYNC, 2)
                        torch.ones(8, 8).sum()
                with profiling.span("t.phase"):
                    profiling.count(profiling.SYNC)
        profiling.count("outside")
    s = profiling.spans()
    assert [x.name for x in s] == ["t.frame", "t.phase", "t.inner", "t.phase"] * 2
    for f in (s[:4], s[4:]):
        root = f[0]
        assert root.parent is None and all(x.root == root.id for x in f)
        assert [x.parent for x in f[1:]] == [root.id, f[1].id, root.id]
        assert [x.counts for x in f] == [{"sync": 3}, {"sync": 2}, {"sync": 2}, {"sync": 1}]
        assert all(x.t1_ns >= x.t0_ns and x.device_s is None for x in f)
    assert s[0].root != s[4].root
    assert profiling.counters() == {"sync": 6, "outside": 1}
    (name,) = os.listdir(log)
    with open(os.path.join(log, name)) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == sorted(x.name for x in s)


def test_frontal_frame_counts_its_syncs(clean, frontal):
    """The upload, the survivors' extraction, three boolean indexes a
    tail stage and the final fetch: 3 + 3 × the frame's tail-stage
    spans, all under one root a frame."""
    det, img = frontal
    with _profiled():
        for _ in range(2):
            det.detect_multi_scale(img, 1.2, 3)
    s = profiling.spans()
    roots = [x for x in s if x.parent is None]
    assert [x.name for x in roots] == ["detect.frame"] * 2
    for root in roots:
        mine = [x for x in s if x.root == root.id]
        stages = sum(x.name == "engine.tail_stage" for x in mine)
        assert stages == len(det.engine.tail_tables.stages)  # a face survives every stage
        assert root.counts["sync"] == 3 + 3 * stages
        assert {x.name for x in mine} == {
            "detect.frame", "detect.raw_windows", "detect.upload", "engine.resize",
            "engine.integral", "engine.prep", "engine.front", "engine.extract",
            "engine.patchify", "engine.tail", "engine.tail_stage", "engine.fetch",
            "detect.group"}
    assert profiling.counters()["sync"] == sum(x.counts["sync"] for x in roots)


@pytest.mark.parametrize("engine,keys", [
    ("fused", {"resize", "integral", "prep", "front", "extract", "patchify", "tail"}),
    ("pallas", {"resize", "integral", "gate", "stage", "walk", "extract"}),
])
def test_engine_timings_fill_the_phase_keys(clean, frontal, engine, keys):
    _, img = frontal
    det = TorchDetector(read_cascade_xml(FRONTAL), device="cpu", impl="ref", engine=engine)
    phases = {}
    for _ in range(2):
        det.raw_windows(img, 1.2, timings=phases)
    assert set(phases) == keys and all(v > 0.0 for v in phases.values())
    assert profiling.spans() == []


def test_timed_scope_is_a_span_keyed_by_its_last_part(clean):
    with _profiled():
        with profiling.span("t.job"):
            with profiling.timed("t.phase_a"):
                pass
    assert list(profiling.timings()) == ["phase_a"]
    job, phase = profiling.spans()
    assert phase.name == "t.phase_a" and phase.parent == job.id
    assert job.counts == {"sync": 2}  # the timed scope's two ends
    assert np.isfinite(profiling.timings()["phase_a"][0])
