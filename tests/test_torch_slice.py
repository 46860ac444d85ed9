"""The PyTorch port's whole detection slices against the JAX package: the
fused engine (interpret mode, dense and packed front) and XLA engine for
the frontal face, the pallas engine (interpret mode) and XLA engine for
the tilted upper body."""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.detector import TPUDetector  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import (  # noqa: E402
    read_cascade_xml as jread_cascade_xml,
)
from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, make_detector  # noqa: E402
from cascadeclassifier_tpu_torch.detect.hog_detector import HOGDetector  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import FEATURE_HOG  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402

from .utils_synth import face_blob_image  # noqa: E402

DATA = os.path.join(  # the port's vendored copies of OpenCV's files
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data",
)
HAAR_ALT = os.path.join(DATA, "haarcascade_frontalface_alt.xml")
UPPERBODY = os.path.join(DATA, "haarcascade_upperbody.xml")


def _sorted(rects):
    return sorted(map(tuple, np.asarray(rects).tolist()))


def test_slice_matches_jax_fused_and_xla_engines():
    """As tests/test_detector.py's hybrid fused test sets it up: the first
    10 stages, front cut over at 50 trees on both sides (stages 1-3 in the
    front, 4-9 in the tail), sf 1.2, minNeighbors 0 — the raw windows."""
    img = face_blob_image(240, 180, n=4, seed=7)
    jm = jread_cascade_xml(HAAR_ALT)
    jm10 = dataclasses.replace(jm, stages=list(jm.stages[:10]))
    fus = TPUDetector(jm10, exact=False, engine="fused", pallas_interpret=True)
    fus._fused.STATIC_FRONT_TREES = 50
    fus._fused.tail_n = 4096
    want_fused = _sorted(fus.detect_multi_scale(img, 1.2, 0))
    want_xla = _sorted(
        TPUDetector(jm10, exact=False, engine="xla").detect_multi_scale(img, 1.2, 0)
    )

    m = read_cascade_xml(HAAR_ALT)
    m10 = dataclasses.replace(m, stages=list(m.stages[:10]))
    det = TorchDetector(m10, exact=False, device="cpu", front_trees=50)
    got = _sorted(det.detect_multi_scale(img, 1.2, 0))
    assert det.engine.n_dense == fus._fused.n_dense == 4
    assert det.engine.last_counts["front_survivors"] > 0  # the tail ran
    assert len(got) > 0
    assert got == want_fused == want_xla


@pytest.fixture(scope="module")
def jax_packed_front_rects():
    """The JAX fused engine with CCTPU_PACKED_FRONT=1 (its plan is then
    shelf-packed, its front the packed band and plane kernels), set up as
    test_slice_matches_jax_fused_and_xla_engines is: run once (~45 s on a
    CPU) for the module."""
    img = face_blob_image(240, 180, n=4, seed=7)
    jm = jread_cascade_xml(HAAR_ALT)
    jm10 = dataclasses.replace(jm, stages=list(jm.stages[:10]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CCTPU_PACKED_FRONT", "1")
        mp.delenv("CCTPU_PACK_BAND", raising=False)
        fus = TPUDetector(jm10, exact=False, engine="fused", pallas_interpret=True)
        fus._fused.STATIC_FRONT_TREES = 50
        fus._fused.tail_n = 4096
        assert fus._fused.wants_packed_plan()
        rects = _sorted(fus.detect_multi_scale(img, 1.2, 0))
    return img, rects


@pytest.mark.parametrize("pack_band,packed_front", [(True, True), (True, False),
                                                    (False, False)])
def test_packed_slice_matches_jax_packed_front_engine(jax_packed_front_rects, pack_band,
                                                      packed_front):
    """The 10-stage slice on the shelf-packed plan with the packed front,
    with the dense front, and on the plain stack: the JAX packed-front
    engine's rects, non-empty."""
    img, want = jax_packed_front_rects
    m = read_cascade_xml(HAAR_ALT)
    m10 = dataclasses.replace(m, stages=list(m.stages[:10]))
    det = TorchDetector(m10, exact=False, device="cpu", front_trees=50,
                        pack_band=pack_band, packed_front=packed_front)
    plan, idx = det.raw_windows(img, 1.2)
    assert plan.packed == pack_band
    assert det.engine.last_counts["front_survivors"] > 0  # the tail ran
    got = _sorted(TorchDetector.group(plan, idx, 0))
    assert len(got) > 0
    assert got == want


def test_max_det_raises_as_the_jax_detector_does():
    """More raw windows than max_det raise RuntimeError with the JAX
    package's wording, in detect_multi_scale on both sides; the defaults
    (1 << 16, and the batch's 1 << 14 raised to 1 << 16) do not."""
    img = face_blob_image(240, 180, n=4, seed=7)
    jm = jread_cascade_xml(HAAR_ALT)
    jdet = TPUDetector(dataclasses.replace(jm, stages=list(jm.stages[:10])),
                       exact=False, engine="xla")
    m = read_cascade_xml(HAAR_ALT)
    det = TorchDetector(dataclasses.replace(m, stages=list(m.stages[:10])),
                        exact=False, device="cpu", front_trees=50)
    n_raw = len(det.raw_windows(img, 1.2)[1])
    assert n_raw > 4
    for d in (jdet, det):
        with pytest.raises(RuntimeError, match=rf"{n_raw} raw detections exceed max_det=4; "
                                               "pass a larger max_det"):
            d.detect_multi_scale(img, 1.2, 0, max_det=4)
    want = _sorted(jdet.detect_multi_scale(img, 1.2, 0))
    assert _sorted(det.detect_multi_scale(img, 1.2, 0)) == want
    assert _sorted(det.detect_multi_scale(img, 1.2, 0, max_det=n_raw)) == want
    assert _sorted(det.detect_multi_scale_batch([img], 1.2, 0, max_det=4)[0]) == want
    with pytest.raises(RuntimeError, match="exceed max_det="):
        det.detect_multi_scale(img, 1.2, 0, max_det=n_raw - 1)


def test_detector_refuses_what_is_not_ported():
    """exact=True, the default as in the JAX package, builds; a HOG cascade
    has no packed form: TorchDetector refuses it and make_detector builds a
    HOGDetector, as the JAX package's detect CLI routes it, refusing the
    engine options; "cuda" without a card raises."""
    m = read_cascade_xml(HAAR_ALT)
    assert TorchDetector(m, device="cpu").exact
    det = TorchDetector(m, exact=True, device="cpu")
    assert det.exact and det.engine.exact and det.engine_name == "fused"
    hog = dataclasses.replace(m, feature_type=FEATURE_HOG, features=[], stages=[])
    with pytest.raises(ValueError):
        TorchDetector(hog, device="cpu")
    assert isinstance(make_detector(hog, device="cpu"), HOGDetector)
    assert isinstance(make_detector(m, device="cpu"), TorchDetector)
    with pytest.raises(TypeError):
        make_detector(hog, device="cpu", engine="fused")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TorchDetector(m, device="cuda")


def test_tilted_slice_matches_jax_pallas_and_xla_engines():
    """The upper body cut to its first 3 stages (tilted trees in each),
    sf 1.2, minNeighbors 0 — the raw windows through the stage engine."""
    img = face_blob_image(200, 150, n=4, seed=7)
    jm = jread_cascade_xml(UPPERBODY)
    jm3 = dataclasses.replace(jm, stages=list(jm.stages[:3]))
    want_pallas = _sorted(
        TPUDetector(jm3, exact=False, engine="pallas", pallas_interpret=True)
        .detect_multi_scale(img, 1.2, 0)
    )
    want_xla = _sorted(
        TPUDetector(jm3, exact=False, engine="xla").detect_multi_scale(img, 1.2, 0)
    )
    m = read_cascade_xml(UPPERBODY)
    m3 = dataclasses.replace(m, stages=list(m.stages[:3]))
    det = TorchDetector(m3, exact=False, device="cpu", engine="pallas")
    got = _sorted(det.detect_multi_scale(img, 1.2, 0))
    assert det.packed.has_tilted
    assert len(got) > 0
    assert got == want_pallas == want_xla


def test_engine_routing():
    """"auto" takes "fused" for an upright cascade and "pallas" for a
    tilted one; "fused" refuses a tilted cascade; "pallas" takes both."""
    face = read_cascade_xml(HAAR_ALT)
    body = read_cascade_xml(UPPERBODY)
    assert TorchDetector(face, device="cpu").engine_name == "fused"
    assert TorchDetector(body, device="cpu").engine_name == "pallas"
    assert TorchDetector(face, device="cpu", engine="pallas").engine_name == "pallas"
    with pytest.raises(ValueError):
        TorchDetector(body, device="cpu", engine="fused")
    with pytest.raises(ValueError):
        TorchDetector(body, device="cpu", engine="xla")
    det = TorchDetector(body, exact=True, device="cpu")
    assert det.engine_name == "pallas" and det.engine.exact


def test_plan_layout_routing():
    """pack_band=None takes the shelf-packed plan for "fused" and the
    plain stack for "pallas"; "pallas" refuses a shelf-packed plan and
    the packed front, as the JAX package asserts."""
    face = read_cascade_xml(HAAR_ALT)
    body = read_cascade_xml(UPPERBODY)
    assert TorchDetector(face, device="cpu").plan_for(320, 240, 1.1, None, None).packed
    assert not TorchDetector(face, device="cpu", pack_band=False).plan_for(
        320, 240, 1.1, None, None).packed
    assert not TorchDetector(body, device="cpu").plan_for(320, 240, 1.1, None, None).packed
    for kw in (dict(pack_band=True), dict(packed_front=True)):
        with pytest.raises(ValueError):
            TorchDetector(body, device="cpu", **kw)
        with pytest.raises(ValueError):
            TorchDetector(face, device="cpu", engine="pallas", **kw)
