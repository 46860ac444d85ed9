"""The PyTorch port on the CPU against the independent OpenCV C++ runtime
(oracle/detect_oracle): the full cascade, the walk's visit set, knife-edge
textures, minSize, the variance gate, and the full tilted upper-body
cascade through the stage engine."""

import dataclasses
import os
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import numpy as np  # noqa: E402

from cascadeclassifier_tpu_torch.detect.detector import TorchDetector  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.utils.synth import synth_frame  # noqa: E402

from .utils_synth import face_blob_image  # noqa: E402

DATA = os.path.join(  # the port's vendored copies of OpenCV's files
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data",
)
HAAR_ALT = os.path.join(DATA, "haarcascade_frontalface_alt.xml")
UPPERBODY = os.path.join(DATA, "haarcascade_upperbody.xml")


def _sorted(rects):
    return sorted(map(tuple, np.asarray(rects).tolist()))


def _oracle(oracle_bin, xml, img, tmp_path, sf, mn, min_size=None):
    p = str(tmp_path / "frame.png")
    cv2.imwrite(p, img)
    extra = [str(v) for v in min_size] if min_size else []
    out = subprocess.run(
        [oracle_bin, xml, p, str(sf), str(mn), *extra],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    assert out[0] == "LOADED"
    return sorted(tuple(map(int, line.split())) for line in out[1:])


def _truncated_xml(tmp_path, n_stages=None, pass_all=False):
    """The cascade cut to its first n stages (or stage 0 made to pass
    every window), written with the port's XML writer so that the oracle
    and the port read the same file."""
    from cascadeclassifier_tpu_torch.models.xml_io import write_cascade_xml

    m = read_cascade_xml(HAAR_ALT)
    stages = list(m.stages[:n_stages])
    if pass_all:
        stages = [dataclasses.replace(m.stages[0], threshold=-1e6)]
    path = str(tmp_path / "cascade.xml")
    write_cascade_xml(dataclasses.replace(m, stages=stages), path)
    return path


def test_full_cascade_matches_opencv_oracle(oracle_bin, tmp_path):
    img = face_blob_image(320, 240, n=6, seed=3)
    det = TorchDetector(read_cascade_xml(HAAR_ALT), exact=False, device="cpu")
    plan, idx = det.raw_windows(img, 1.1)
    for mn in (0, 3):
        ref = _oracle(oracle_bin, HAAR_ALT, img, tmp_path, 1.1, mn)
        got = _sorted(TorchDetector.group(plan, idx, mn))
        assert len(ref) > 0
        assert got == ref, f"minNeighbors {mn}"


@pytest.mark.parametrize("w,h", [(137, 101), (64, 55), (200, 173)])
def test_visit_set_matches_oracle(oracle_bin, tmp_path, w, h):
    """A stage 0 that passes every window: the raw output is exactly the
    OpenCV walk's visit set (ystep, stripe bound, x bound, f32 cvRound
    mapping, clipping), through the port's whole pipeline."""
    xml = _truncated_xml(tmp_path, pass_all=True)
    img = np.random.default_rng(7).integers(0, 256, (h, w)).astype(np.uint8)
    det = TorchDetector(read_cascade_xml(xml), exact=False, device="cpu")
    ref = _oracle(oracle_bin, xml, img, tmp_path, 1.1, 0)
    assert len(ref) > 100
    assert _sorted(det.detect_multi_scale(img, 1.1, 0)) == ref


def test_full_tilted_cascade_matches_opencv_oracle(oracle_bin, tmp_path):
    """haarcascade_upperbody.xml (30 stages, 474 tilted trees) at 320x240
    through TorchDetector's stage engine ("pallas", chosen by "auto"), on
    the port's synth frame 0 (the face blobs fire no upper body)."""
    img = synth_frame(0, 240, 320)
    det = TorchDetector(read_cascade_xml(UPPERBODY), exact=False, device="cpu")
    assert det.engine_name == "pallas"
    plan, idx = det.raw_windows(img, 1.1)
    for mn in (0, 3):
        ref = _oracle(oracle_bin, UPPERBODY, img, tmp_path, 1.1, mn)
        if mn == 0:
            assert len(ref) > 0
        assert _sorted(TorchDetector.group(plan, idx, mn)) == ref, f"minNeighbors {mn}"


def test_random_textures_and_min_size_match_oracle(oracle_bin, tmp_path):
    """8 stages on blurred noise (windows near the stage thresholds) and a
    minSize filter on face blobs, against the oracle."""
    xml = _truncated_xml(tmp_path, n_stages=8)
    det = TorchDetector(read_cascade_xml(xml), exact=False, device="cpu")
    rng = np.random.default_rng(11)
    tex = cv2.GaussianBlur(
        rng.integers(0, 256, (160, 200)).astype(np.uint8), (7, 7), 2.0
    )
    ref = _oracle(oracle_bin, xml, tex, tmp_path, 1.2, 0)
    assert len(ref) > 0
    assert _sorted(det.detect_multi_scale(tex, 1.2, 0)) == ref
    faces = face_blob_image(240, 180, n=6, seed=3)
    ref = _oracle(oracle_bin, xml, faces, tmp_path, 1.2, 0, (40, 40))
    assert len(ref) > 0
    assert _sorted(det.detect_multi_scale(faces, 1.2, 0, min_size=(40, 40))) == ref


def test_variance_gate_rejects_flat_frames():
    det = TorchDetector(read_cascade_xml(HAAR_ALT), exact=False, device="cpu")
    flat = np.full((180, 240), 90, np.uint8)
    assert len(det.detect_multi_scale(flat, 1.2, 0)) == 0
