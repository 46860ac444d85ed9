"""LBP cascades in the PyTorch port against the JAX package: the LBP code
(``ops/features.py``), ``dense_stage_lbp`` and, for a hand-built cascade
of 2-node LBP trees, ``dense_stage_deep``, bit for bit in f32 and f64;
the LBP record mirror; the packing of every OpenCV LBP cascade; the
detector's raw windows through both port engines; and the full
lbpcascade_frontalface against the OpenCV oracle. Every comparison is
exact (bit for bit, or equal sets of windows)."""

import dataclasses
import glob
import os
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect import dense as jdense  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.detect.detector import TPUDetector  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import (  # noqa: E402
    read_cascade_xml as jread_cascade_xml,
)
from cascadeclassifier_tpu.ops.features import lbp_code_grid as jlbp_code_grid  # noqa: E402
from cascadeclassifier_tpu_torch.convert import from_jax_packed  # noqa: E402
from cascadeclassifier_tpu_torch.detect import dense, records  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    PackedCascade,
    TorchDetector,
)
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import lbp_code_grid  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    edge_mismatches,
    lbp_two_node_model,
    policy_ranges,
    truncated,
)

LBP = os.path.join(  # the port's vendored copy of OpenCV's file
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data", "lbpcascade_frontalface.xml",
)
LBP_DIR = "/usr/share/opencv4/lbpcascades"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed():
    """name → (JAX PackedCascade, its conversion, the port's own packing)
    for the LBP frontal face and its 2-node version."""
    out = {}
    for name, build in (("frontal", lambda m: m), ("two_node", lbp_two_node_model)):
        jp = JPackedCascade.from_model(build(jread_cascade_xml(LBP)))
        out[name] = (jp, from_jax_packed(jp), PackedCascade.from_model(build(
            read_cascade_xml(LBP))))
    return out


def _canvas(seed, out_h, out_w, win_w, win_h):
    """A seeded integral canvas (int32, wrapped) as numpy."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (out_h + win_h, out_w + win_w)).astype(np.int64)
    return (px.cumsum(0).cumsum(1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _sorted(rects):
    return sorted(map(tuple, np.asarray(rects).tolist()))


def test_lbp_code_grid_matches_jax():
    """Random int32 cell sums, many equal to the centre (the compare is >=)
    and negative ones (signed)."""
    rng = np.random.default_rng(0)
    cs = rng.integers(-3, 4, (3, 3, 40, 50)).astype(np.int32)
    cs[:, :, :5] = rng.integers(-(1 << 31), 1 << 31, (3, 3, 5, 50)).astype(np.int32)
    want = np.asarray(jlbp_code_grid(jnp.asarray(cs)))
    got = lbp_code_grid(torch.from_numpy(cs)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 200


@pytest.mark.parametrize("exact", [False, True])
def test_dense_stage_lbp_matches_jax_bitwise(packed, exact):
    jp, conv, _ = packed["frontal"]
    out_h, out_w = 19, 37
    s = _canvas(1, out_h, out_w, conv.win_w, conv.win_h)
    for si in (0, 5, 11):
        with jax.enable_x64(exact):
            want = np.asarray(jdense.dense_stage_lbp(jnp.asarray(s), jp.stages[si], out_h,
                                                     out_w, exact=exact))
        got = dense.dense_stage_lbp(torch.from_numpy(s), conv.stages[si], out_h, out_w,
                                    exact=exact).numpy()
        assert want.dtype == got.dtype == (np.float64 if exact else np.float32)
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("exact", [False, True])
def test_dense_stage_deep_lbp_two_node_matches_jax_bitwise(packed, exact):
    """A hand-built cascade of 2-node LBP trees (utils/edges.py), carried
    across from the JAX package's packing: node trees of subsets."""
    jp, conv, ours = packed["two_node"]
    assert conv.kind == ours.kind == "lbp" and all(st.deep_trees for st in conv.stages)
    out_h, out_w = 19, 37
    s = _canvas(2, out_h, out_w, conv.win_w, conv.win_h)
    zeros = np.zeros((out_h, out_w), np.float32)
    for si in range(len(conv.stages)):
        with jax.enable_x64(exact):
            want = np.asarray(jdense.dense_stage_deep(
                jnp.asarray(s), jnp.asarray(s), jp.stages[si], out_h, out_w,
                jnp.asarray(zeros), False, exact=exact))
        got = dense.dense_stage_deep(torch.from_numpy(s), None, conv.stages[si], out_h, out_w,
                                     None, False, exact=exact).numpy()
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        mine = dense.dense_stage_deep(torch.from_numpy(s), None, ours.stages[si], out_h, out_w,
                                      None, False, exact=exact).numpy()
        np.testing.assert_array_equal(mine.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name,si", [("frontal", 4), ("two_node", 1)])
def test_lbp_records_mirror_matches_twin(packed, name, si, exact):
    """A stage's LBP records walked tile by tile as the kernels walk them,
    against dense.stage_pass(lbp=True); the last tile row and column
    partial."""
    cas = packed[name][2]
    st = cas.stages[si]
    out_h, out_w = records.TILE_H + 5, records.TILE_W + 9
    s = _canvas(si, out_h, out_w, cas.win_w, cas.win_h)
    tables = records.node_tables([st], cas.win_w, cas.win_h, True, False)
    assert tables[0].dtype == records.LBP_RECORD
    want = dense.stage_pass(torch.from_numpy(s), st, out_h, out_w, None, exact=exact,
                            lbp=True).numpy()
    got = records.node_records_stage_pass(tables, st.threshold, s, None, None, cas.win_w,
                                          cas.win_h, exact)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_every_opencv_lbp_cascade_packs_and_fits_the_tile():
    """The five lbpcascade files, windows 12x80 to 45x45: packed, their
    records built, every grid corner inside the window's patch."""
    paths = sorted(glob.glob(os.path.join(LBP_DIR, "lbpcascade_*.xml")))
    if not paths:
        pytest.skip("OpenCV's LBP cascades are not installed")
    sizes = set()
    for path in paths:
        cas = PackedCascade.from_model(read_cascade_xml(path))
        tab = cas.device_table("cpu")
        assert cas.kind == "lbp" and tab["records"].shape[1] == 80
        rec = tab["records"].numpy().view(records.LBP_RECORD).reshape(-1)
        pitch = records.tile_pitch(cas.win_w)
        corner = rec["corner"].astype(np.int64)
        assert (corner // pitch <= cas.win_h).all() and (corner % pitch <= cas.win_w).all()
        sizes.add((cas.win_w, cas.win_h))
    assert (12, 80) in sizes and (45, 45) in sizes


def test_lbp_grid_must_lie_inside_the_window(packed):
    """The 3 x 3 cells of w x h from (x, y) end at (x + 3w, y + 3h)."""
    cas = packed["frontal"][2]
    st = cas.stages[0]
    bad = st.lbp_rects.copy()
    bad[0] = (cas.win_w - 2, 0, 1, 1)  # x + 3w = win_w + 1
    with pytest.raises(ValueError):
        PackedCascade(win_w=cas.win_w, win_h=cas.win_h, stages=[
            dataclasses.replace(st, lbp_rects=bad)], feature_type=cas.feature_type)
    bad[0] = (cas.win_w - 3, 0, 1, 1)  # x + 3w = win_w: inside
    PackedCascade(win_w=cas.win_w, win_h=cas.win_h, stages=[
        dataclasses.replace(st, lbp_rects=bad)], feature_type=cas.feature_type)


@pytest.mark.parametrize("name", ["frontal", "two_node"])
def test_lbp_slice_matches_jax_xla_engine(name):
    """The LBP frontal face cut to 5 stages, and the 2-node cascade (3
    stages), exact=True (the default), sf 1.2, minNeighbors 0: raw windows
    through both port engines ("auto" picks "pallas") equal
    TPUDetector(engine="xla")'s."""
    from .utils_synth import face_blob_image

    pytest.importorskip("cv2")
    build = (lambda m: truncated(m, 5)) if name == "frontal" else lbp_two_node_model
    img = face_blob_image(200, 150, n=4, seed=7)
    want = _sorted(TPUDetector(build(jread_cascade_xml(LBP)), exact=True, engine="xla")
                   .detect_multi_scale(img, 1.2, 0))
    m = build(read_cascade_xml(LBP))
    assert len(want) > 0
    assert TorchDetector(m, device="cpu").engine_name == "pallas"
    for engine in ("pallas", "fused"):
        det = TorchDetector(m, device="cpu", engine=engine)
        assert _sorted(det.detect_multi_scale(img, 1.2, 0)) == want, engine


def test_lbp_raw_window_parity_with_opencv_oracle(oracle_bin, tmp_path):
    """tests/test_detector.py::test_lbp_raw_window_parity through the port:
    the full lbpcascade_frontalface (20 stages) on the face-blob frame, sf
    1.2, minNeighbors 0 and 3, both port engines."""
    import cv2

    from .utils_synth import face_blob_image

    img = face_blob_image(240, 180, n=6, seed=3)
    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, img)
    m = read_cascade_xml(LBP)
    for mn in (0, 3):
        out = subprocess.run([oracle_bin, LBP, png, "1.2", str(mn)], capture_output=True,
                             text=True, check=True).stdout.splitlines()
        assert out[0] == "LOADED"
        ref = sorted(tuple(map(int, line.split())) for line in out[1:])
        if mn == 0:
            assert len(ref) > 0
        for engine in ("pallas", "fused"):
            det = TorchDetector(m, device="cpu", engine=engine)
            assert _sorted(det.detect_multi_scale(img, 1.2, mn)) == ref, (engine, mn)


@pytest.mark.cuda
def test_lbp_kernels_match_twins_on_card(packed, cuda_device):
    """The stage and front kernels' LBP policy at the tile edges, f32 and
    f64, on the LBP frontal face and the 2-node cascade."""
    for name in ("frontal", "two_node"):
        cas = packed[name][2]
        for exact in (False, True):
            for use_stage in (True, False):
                _, survivors, bad = edge_mismatches(
                    cas, policy_ranges(len(cas.stages), use_stage), cuda_device, use_stage,
                    exact=exact)
                torch.cuda.synchronize()
                assert not bad and survivors > 0


def test_vendored_lbp_cascade_is_the_opencv_file():
    with open(LBP, "rb") as f:
        vendored = f.read()
    assert b"<featureType>LBP</featureType>" in vendored
    src = os.path.join(LBP_DIR, "lbpcascade_frontalface.xml")
    if not os.path.exists(src):
        pytest.skip("lbpcascade_frontalface.xml not installed")
    with open(src, "rb") as f:
        assert vendored == f.read()


def test_lbp_golden_frames_and_counts():
    """data/smoke_golden_lbp_1080p.json: OpenCV's rects on synth frames 0
    and 1, non-vacuous at both minNeighbors."""
    import hashlib
    import json

    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    with open(os.path.join(os.path.dirname(LBP), "smoke_golden_lbp_1080p.json")) as f:
        golden = json.load(f)
    assert golden["cascade"] == "lbpcascade_frontalface.xml"
    assert [g["k"] for g in golden["frames"]] == [0, 1]
    for g in golden["frames"]:
        frame = synth_frame(g["k"], golden["height"], golden["width"])
        assert hashlib.sha256(frame.tobytes()).hexdigest() == g["sha256"]
        assert len(g["rects_mn3"]) > 0 and len(g["rects_mn0"]) > len(g["rects_mn3"])
