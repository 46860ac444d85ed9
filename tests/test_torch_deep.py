"""Haar node-tree (deep-tree) cascades in the PyTorch port against the JAX
package: the packing and its conversion, ``dense_stage_deep`` bit for bit
in f32 and f64 on haarcascade_frontalface_alt2 (2-node trees) and
haarcascade_eye_tree_eyeglasses (3-node trees, tilted and upright nodes
mixed), the node-record mirror, the detector's raw windows through both
port engines, the tilted depth-2 cascade against the JAX package's fused
engine, and depth-2 trees against the OpenCV oracle. Every
comparison is exact (bit for bit, or equal sets of windows)."""

import dataclasses
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
from cascadeclassifier_tpu_torch.convert import from_jax_packed  # noqa: E402
from cascadeclassifier_tpu_torch.detect import dense, records  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    PackedCascade,
    TorchDetector,
)
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    edge_mismatches,
    policy_ranges,
    truncated,
)

DATA = os.path.join(  # the port's vendored copies of OpenCV's files
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data",
)
ALT2 = os.path.join(DATA, "haarcascade_frontalface_alt2.xml")
EYE_TREE = os.path.join(DATA, "haarcascade_eye_tree_eyeglasses.xml")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed():
    """name → (JAX PackedCascade, its conversion, the port's own packing)."""
    out = {}
    for name, xml in (("alt2", ALT2), ("eye_tree", EYE_TREE)):
        jp = JPackedCascade.from_model(jread_cascade_xml(xml))
        out[name] = (jp, from_jax_packed(jp), PackedCascade.from_model(read_cascade_xml(xml)))
    return out


def _canvases(seed, out_h, out_w, win_w, win_h):
    """A seeded integral canvas, a tilted canvas of arbitrary int32 values
    and a positive inv_nf, as numpy."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (out_h + win_h, out_w + win_w)).astype(np.int64)
    sum2d = (px.cumsum(0).cumsum(1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    tilt2d = rng.integers(-(1 << 31), 1 << 31, sum2d.shape).astype(np.int32)
    inv_nf = rng.uniform(1e-4, 2e-2, (out_h, out_w)).astype(np.float32)
    return sum2d, tilt2d, inv_nf


def _sorted(rects):
    return sorted(map(tuple, np.asarray(rects).tolist()))


@pytest.mark.parametrize("name,trees,nodes,tilted", [("alt2", 1047, 2094, False),
                                                     ("eye_tree", 851, 2553, True)])
def test_packing_of_node_tree_cascades(packed, name, trees, nodes, tilted):
    """The port's packing equals the JAX package's carried across by
    convert.from_jax_packed, node trees and all; the node tables hold one
    record a node and three or four leaves a tree."""
    jp, conv, ours = packed[name]
    assert ours.kind == conv.kind == "node" and ours.has_tilted == conv.has_tilted == tilted
    for a, b, j in zip(ours.stages, conv.stages, jp.stages):
        assert a.threshold == b.threshold == j.threshold
        for f in ("feat_rects", "weights", "tilted", "thr", "left_leaf", "right_leaf"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for (ta, fa), (tb, fb) in zip(a.deep_trees, b.deep_trees):
            for f in ("left", "right", "feature_idx", "threshold", "leaf_values"):
                np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
            assert fa == fb
    tab = ours.device_table("cpu")
    assert tuple(tab["records"].shape) == (nodes, 48) and tab["kind"] == records.KINDS["node"]
    assert tab["tree_root"].numel() == trees and tab["leaves"].numel() == nodes + trees


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name,stage_ids", [("alt2", (0, 4)), ("eye_tree", (0, 2))])
def test_dense_stage_deep_matches_jax_bitwise(packed, name, stage_ids, exact):
    """Stage sums at every position of a random canvas (tilted nodes read
    a random tilted canvas), on the converted cascade in the port and the
    JAX package's own, bit for bit."""
    jp, conv, _ = packed[name]
    out_h, out_w = 19, 37
    s, t, inv = _canvases(3, out_h, out_w, conv.win_w, conv.win_h)
    for si in stage_ids:
        with jax.enable_x64(exact):
            want = np.asarray(jdense.dense_stage_deep(
                jnp.asarray(s), jnp.asarray(t), jp.stages[si], out_h, out_w, jnp.asarray(inv),
                True, exact=exact))
        got = dense.dense_stage_deep(torch.from_numpy(s), torch.from_numpy(t), conv.stages[si],
                                     out_h, out_w, torch.from_numpy(inv), True,
                                     exact=exact).numpy()
        assert want.dtype == got.dtype == (np.float64 if exact else np.float32)
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name,si", [("alt2", 3), ("eye_tree", 1)])
def test_node_records_mirror_matches_twin(packed, name, si, exact):
    """A stage's node records walked tile by tile as the kernels walk them,
    against dense.stage_pass; two tile rows and columns, the last partial."""
    cas = packed[name][2]
    st = cas.stages[si]
    out_h, out_w = records.TILE_H + 5, records.TILE_W + 9
    s, t, inv = _canvases(si, out_h, out_w, cas.win_w, cas.win_h)
    tables = records.node_tables([st], cas.win_w, cas.win_h, False, cas.has_tilted)
    want = dense.stage_pass(torch.from_numpy(s), st, out_h, out_w, torch.from_numpy(inv),
                            torch.from_numpy(t), exact=exact).numpy()
    got = records.node_records_stage_pass(tables, st.threshold, s,
                                          t if cas.has_tilted else None, inv, cas.win_w,
                                          cas.win_h, exact)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("name,engines", [("alt2", ("fused", "pallas")),
                                          ("eye_tree", ("pallas",))])
def test_deep_slice_matches_jax_xla_engine(name, engines):
    """The cascade cut to 4 stages, exact=True (the default), sf 1.2,
    minNeighbors 0: raw windows through each port engine that takes it
    ("auto" picks "pallas") equal TPUDetector(engine="xla")'s."""
    from .utils_synth import face_blob_image

    pytest.importorskip("cv2")
    xml = ALT2 if name == "alt2" else EYE_TREE
    img = face_blob_image(200, 150, n=4, seed=7)
    want = _sorted(TPUDetector(truncated(jread_cascade_xml(xml), 4), exact=True, engine="xla")
                   .detect_multi_scale(img, 1.2, 0))
    m = truncated(read_cascade_xml(xml), 4)
    assert TorchDetector(m, device="cpu").engine_name == "pallas"
    assert len(want) > 0
    for engine in engines:
        det = TorchDetector(m, device="cpu", engine=engine)
        assert _sorted(det.detect_multi_scale(img, 1.2, 0)) == want, engine
        if engine == "fused":
            assert det.engine.n_dense == 4  # every stage in the front, no tail


def test_deep_tree_parity_with_opencv_oracle(oracle_bin, tmp_path):
    """tests/test_detector.py::test_deep_tree_parity through the port: two
    trees of depth 2 and 1 over three Haar features, written as XML by the
    port's writer, through both port engines against the oracle."""
    import cv2

    from cascadeclassifier_tpu_torch.models.model import (
        CascadeModel,
        HaarFeature,
        Stage,
        WeakTree,
    )
    from cascadeclassifier_tpu_torch.models.xml_io import write_cascade_xml

    from .utils_synth import face_blob_image

    t1 = WeakTree(
        left=np.array([1, 0, -1], np.int32), right=np.array([2, -2, -3], np.int32),
        feature_idx=np.array([0, 1, 2], np.int32),
        threshold=np.array([0.01, -0.05, 0.03], np.float32),
        leaf_values=np.array([0.9, -0.8, 0.7, -0.6], np.float32),
    )
    t2 = WeakTree(
        left=np.array([0], np.int32), right=np.array([-1], np.int32),
        feature_idx=np.array([1], np.int32), threshold=np.array([0.0], np.float32),
        leaf_values=np.array([0.5, -0.5], np.float32),
    )
    m = CascadeModel(
        feature_type=0, width=20, height=20, stages=[Stage(threshold=0.2, trees=[t1, t2])],
        features=[
            HaarFeature(rects=[(2, 2, 8, 8, -1.0), (2, 2, 4, 8, 2.0)]),
            HaarFeature(rects=[(4, 4, 12, 6, -1.0), (4, 7, 12, 3, 2.0)]),
            HaarFeature(rects=[(0, 0, 20, 20, -1.0), (5, 5, 10, 10, 4.0)]),
        ],
        max_depth=2,
    )
    xml = str(tmp_path / "deep.xml")
    write_cascade_xml(m, xml)
    img = face_blob_image(240, 180, n=6, seed=3)
    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, img)
    out = subprocess.run([oracle_bin, xml, png, "1.2", "0"], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert out[0] == "LOADED"
    ref = sorted(tuple(map(int, line.split())) for line in out[1:])
    assert len(ref) > 0
    port = read_cascade_xml(xml)
    for engine in ("fused", "pallas"):
        det = TorchDetector(port, device="cpu", engine=engine)
        assert det.packed.kind == "node"
        assert _sorted(det.detect_multi_scale(img, 1.2, 0)) == ref, engine


def test_fused_engine_tilted_deep_parity():
    """Mirrors tests/test_detector.py::test_fused_engine_tilted_deep_parity:
    eye_tree_eyeglasses cut to 4 stages (tilted and upright nodes, depth-2
    trees), f32 sums (exact=False), sf 1.2, minNeighbors 0, on blurred
    noise: the port's detector ("auto" sends the cascade to the stage
    engine; its fused engine refuses tilted node trees) gives the JAX
    package's fused and XLA engines' rects."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(6)
    img = cv2.GaussianBlur(rng.integers(0, 256, (120, 160)).astype(np.uint8), (9, 9), 3)
    jm = truncated(jread_cascade_xml(EYE_TREE), 4)
    want = _sorted(TPUDetector(jm, exact=False, engine="xla").detect_multi_scale(img, 1.2, 0))
    fused = TPUDetector(jm, exact=False, engine="fused")
    assert fused._fused is not None
    assert _sorted(fused.detect_multi_scale(img, 1.2, 0)) == want and len(want) > 0
    det = TorchDetector(truncated(read_cascade_xml(EYE_TREE), 4), exact=False, device="cpu")
    assert det.engine_name == "pallas" and det.packed.kind == "node" and det.packed.has_tilted
    assert _sorted(det.detect_multi_scale(img, 1.2, 0)) == want


def test_tilted_node_corners_point_into_the_tilted_patch(packed):
    """eye_tree mixes tilted and upright nodes within a tree: each node
    record's corners lie in the patch of its own feature's kind."""
    cas = packed["eye_tree"][2]
    rec, _, _ = records.node_tables(cas.stages, cas.win_w, cas.win_h, False, True)
    bias = records.tilt_bias(cas.win_w, cas.win_h)
    tilted = np.array([f.tilted for st in cas.stages for _, feats in st.deep_trees
                       for f in feats])
    used = rec["weight"] != 0
    in_tilted = (rec["corner"].astype(np.int64) >= bias) & used[:, :, None]
    assert tilted.any() and not tilted.all()
    np.testing.assert_array_equal(in_tilted.any(axis=(1, 2)), tilted)
    assert (in_tilted.all(axis=2) == (used & tilted[:, None])).all()
    mixed = [any(f.tilted for f in feats) and not all(f.tilted for f in feats)
             for st in cas.stages for _, feats in st.deep_trees]
    assert any(mixed)


@pytest.mark.cuda
def test_node_kernels_match_twins_on_card(packed, cuda_device):
    """The stage and front kernels' node-tree policy at the tile edges, f32
    and f64: alt2 (front and stage) and eye_tree cut to 4 stages (stage,
    with its tilted canvas)."""
    cascades = (packed["alt2"][2], PackedCascade.from_model(truncated(
        read_cascade_xml(EYE_TREE), 4)))
    for cas in cascades:
        for exact in (False, True):
            for use_stage in (True, False):
                if cas.has_tilted and not use_stage:
                    continue
                _, _, bad = edge_mismatches(cas, policy_ranges(len(cas.stages), use_stage),
                                            cuda_device, use_stage, exact=exact)
                torch.cuda.synchronize()
                assert not bad


def test_fused_engine_refuses_tilted_node_trees(packed):
    """eye_tree is tilted: "fused" refuses it, as for tilted stumps."""
    m = read_cascade_xml(EYE_TREE)
    with pytest.raises(ValueError):
        TorchDetector(m, device="cpu", engine="fused")
    with pytest.raises(ValueError):
        TorchDetector(read_cascade_xml(ALT2), device="cpu", packed_front=True)
    m2 = dataclasses.replace(m, stages=m.stages[:1])
    assert TorchDetector(m2, device="cpu").engine_name == "pallas"


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt2.xml",
                                  "haarcascade_eye_tree_eyeglasses.xml"])
def test_vendored_node_tree_cascades_are_the_opencv_files(name):
    with open(os.path.join(DATA, name), "rb") as f:
        vendored = f.read()
    assert b"Intel License Agreement" in vendored
    src = os.path.join("/usr/share/opencv4/haarcascades", name)
    if not os.path.exists(src):
        pytest.skip(f"{name} not installed")
    with open(src, "rb") as f:
        assert vendored == f.read()


def test_alt2_golden_frames_and_counts():
    """data/smoke_golden_alt2_1080p.json: OpenCV's rects on synth frames 0
    and 1, non-vacuous at both minNeighbors."""
    import hashlib
    import json

    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    with open(os.path.join(DATA, "smoke_golden_alt2_1080p.json")) as f:
        golden = json.load(f)
    assert golden["cascade"] == "haarcascade_frontalface_alt2.xml"
    assert [g["k"] for g in golden["frames"]] == [0, 1]
    for g in golden["frames"]:
        frame = synth_frame(g["k"], golden["height"], golden["width"])
        assert hashlib.sha256(frame.tobytes()).hexdigest() == g["sha256"]
        assert len(g["rects_mn3"]) > 0 and len(g["rects_mn0"]) > len(g["rects_mn3"])
