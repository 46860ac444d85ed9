"""The readers of the program's spans and counts (``metrics/syncs_per_frame.py``,
``syncs_per_job.py``, ``precalc_s.py``) on the CPU: nothing to read gives None,
a tracer state built by hand gives its value."""

from types import SimpleNamespace

import pytest

from benchmark import manifest
from benchmark.metrics_ctx import Context

torch = pytest.importorskip("torch")

from cascadeclassifier_tpu_torch.utils import profiling  # noqa: E402

READERS = ("syncs_per_frame", "syncs_per_job", "precalc_s")


def _span(id, name, parent=None, root=None, sync=0, device_s=None):
    return SimpleNamespace(id=id, name=name, parent=parent, root=id if root is None else root,
                           counts={"sync": sync} if sync else {}, device_s=device_s)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_tracer_reads_none(name, monkeypatch):
    profiling.reset()
    assert manifest.reader(name).read(Context()) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the tracer
    assert manifest.reader(name).read(Context()) is None


def test_syncs_per_frame_by_hand(monkeypatch):
    state = []
    for f in range(4):  # a cell's frame: raw_windows, then group, each a root
        a, b = 10 * f + 1, 10 * f + 2
        state += [_span(a, "detect.raw_windows", sync=45), _span(a + 5, "engine.tail_stage", a, a,
                                                                   sync=3),
                  _span(b, "detect.group")]
    state.append(_span(99, "detect.frame", sync=41))  # detect_multi_scale's root
    monkeypatch.setattr(profiling, "spans", lambda: state)
    assert manifest.reader("syncs_per_frame").read(Context(frames=5)) == pytest.approx(
        (4 * 45 + 41) / 5)
    monkeypatch.setattr(profiling, "spans", lambda: state[2:3])  # no frame root
    assert manifest.reader("syncs_per_frame").read(Context()) is None


def test_job_readers_by_hand(monkeypatch):
    state = [_span(1, "train.job", sync=120),
             _span(2, "train.stage", 1, 1, sync=60),
             _span(3, "boost.precalc", 2, 1, device_s=0.125),
             _span(4, "boost.precalc", 2, 1, device_s=0.0625),
             _span(5, "boost.precalc", None, 5, device_s=9.0)]  # outside any job
    monkeypatch.setattr(profiling, "spans", lambda: state)
    assert manifest.reader("syncs_per_job").read(Context()) == 120
    assert manifest.reader("precalc_s").read(Context()) == pytest.approx(0.1875)
    state[3].device_s = None  # spans of a CPU run have no device time
    assert manifest.reader("precalc_s").read(Context()) is None
    monkeypatch.setattr(profiling, "spans", lambda: state[1:])  # no job root
    assert manifest.reader("syncs_per_job").read(Context()) is None
    assert manifest.reader("precalc_s").read(Context()) is None


def test_a_cpu_frame_reads_its_counted_syncs(monkeypatch):
    """The reader over the tracer as the program leaves it: a frontal frame
    through the detection cell's two calls on the CPU."""
    import numpy as np

    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml

    cfg = manifest.cell(manifest.load(), "frontal_alt.video2160")["config"]
    det = TorchDetector(read_cascade_xml(f"{cfg['_dir']}/{cfg['cascade']}"), device="cpu",
                        impl="ref")
    img = np.full((90, 120), 128, np.uint8)
    img[20:60, 30:70] = 200
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        plan, idx = det.raw_windows(img, 1.2)
        det.group(plan, idx, 3)
    got = manifest.reader("syncs_per_frame").read(Context(frames=1))
    stages = sum(s.name == "engine.tail_stage" for s in profiling.spans())
    profiling.reset()
    assert got == 3 + 3 * stages  # upload, extraction, fetch, 3 a tail stage
