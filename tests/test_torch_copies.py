"""The PyTorch port's numpy copies (XML reader and writer, pyramid plan,
grouping, packed cascade, .vec I/O, the negative reader, the Haar
catalogs, the host resize), the state carried over by convert.py, the
synthetic frames behind the committed golden, and the port's independence
from jax."""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect import grouping as jgrouping  # noqa: E402
from cascadeclassifier_tpu.detect import pyramid as jpyramid  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.models import xml_io as jxml_io  # noqa: E402
from cascadeclassifier_tpu_torch.convert import from_jax_packed, plan_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.detect import grouping, pyramid  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import PackedCascade  # noqa: E402
from cascadeclassifier_tpu_torch.models import xml_io  # noqa: E402
from cascadeclassifier_tpu_torch.utils.synth import synth_frame  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "cascadeclassifier_tpu_torch", "data")
VENDORED = os.path.join(DATA, "haarcascade_frontalface_alt.xml")
CASCADES = "/usr/share/opencv4/haarcascades"


def _assert_same(a, b, path="model"):
    """Recursive equality of dataclasses / lists / arrays / scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert (a is None) == (b is None), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name", [
    "haarcascade_frontalface_alt.xml",
    "haarcascade_eye.xml",
    "haarcascade_frontalface_alt_tree.xml",
    "haarcascade_upperbody.xml",
])
def test_read_cascade_xml_matches_original(name):
    path = os.path.join(CASCADES, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not installed")
    _assert_same(xml_io.read_cascade_xml(path), jxml_io.read_cascade_xml(path))


def test_vendored_cascade_is_the_opencv_file():
    with open(VENDORED, "rb") as f:
        vendored = f.read()
    assert b"Intel License Agreement" in vendored
    with open(os.path.join(CASCADES, "haarcascade_frontalface_alt.xml"), "rb") as f:
        assert vendored == f.read()


def test_vendored_upperbody_cascade_is_the_opencv_file():
    with open(os.path.join(DATA, "haarcascade_upperbody.xml"), "rb") as f:
        vendored = f.read()
    assert b"Hannes Kruppa and Bernt Schiele" in vendored  # the license header
    src = os.path.join(CASCADES, "haarcascade_upperbody.xml")
    if not os.path.exists(src):
        pytest.skip("haarcascade_upperbody.xml not installed")
    with open(src, "rb") as f:
        assert vendored == f.read()


@pytest.mark.parametrize("args", [
    (160, 120, 20, 20, 1.1, None, None),
    (640, 480, 20, 20, 1.2, (40, 40), None),
    (320, 240, 24, 24, 1.1, None, (150, 150)),
    (137, 101, 20, 20, 1.05, None, None),
])
def test_build_plan_matches_unpacked_original(args):
    jplan = jpyramid.build_plan(*args)
    plan = pyramid.build_plan(*args)
    for f in dataclasses.fields(plan):
        np.testing.assert_array_equal(
            getattr(plan, f.name), getattr(jplan, f.name), err_msg=f.name
        )
    _assert_same(plan_from_jax(jplan), plan)
    assert pyramid.opencv_scales(*args[:5]) == jpyramid.opencv_scales(*args[:5])


@pytest.mark.parametrize("args", [
    (1920, 1080, 20, 20, 1.1, None, None),
    (1920, 1080, 22, 18, 1.1, None, None),
    (320, 240, 20, 20, 1.1, None, None),
    (160, 120, 20, 20, 1.1, None, None),
])
def test_build_plan_matches_packed_original(args):
    """Shelf packing (pack_band=True), field by field: placement, level
    map, ystep-2 rows and the 2-D anchor grid."""
    jplan = jpyramid.build_plan(*args, pack_band=True)
    plan = pyramid.build_plan(*args, pack_band=True)
    assert plan.packed and plan.grid2d.shape == (plan.out_h, plan.out_w)
    assert plan.block_left.any()  # some level sits beside another
    for f in dataclasses.fields(plan):
        np.testing.assert_array_equal(
            getattr(plan, f.name), getattr(jplan, f.name), err_msg=f.name
        )
    _assert_same(plan_from_jax(jplan), plan)
    unpacked = pyramid.build_plan(*args)
    assert plan.canvas_w == unpacked.canvas_w and plan.canvas_h < unpacked.canvas_h
    np.testing.assert_array_equal(plan.stack_top, unpacked.block_top)


@pytest.mark.parametrize("n,thr", [(0, 2), (40, 0), (40, 1), (200, 3), (300, 2)])
def test_group_rectangles_matches_original(n, thr):
    rng = np.random.default_rng(n + thr)
    centers = rng.integers(0, 300, (max(n // 8, 1), 2))
    pick = rng.integers(0, len(centers), n)
    size = rng.integers(20, 90, n)
    rects = np.stack([
        centers[pick, 0] + rng.integers(-4, 5, n),
        centers[pick, 1] + rng.integers(-4, 5, n),
        size, size + rng.integers(-2, 3, n),
    ], axis=1).astype(np.int32)
    got = grouping.group_rectangles(rects, thr)
    np.testing.assert_array_equal(got, jgrouping.group_rectangles(rects, thr))
    np.testing.assert_array_equal(
        grouping.clip_rects(got, 250, 200), jgrouping.clip_rects(got, 250, 200)
    )


def test_packed_cascade_matches_original_and_conversion():
    m = xml_io.read_cascade_xml(VENDORED)
    jp = JPackedCascade.from_model(jxml_io.read_cascade_xml(VENDORED))
    ours = PackedCascade.from_model(m)
    conv = from_jax_packed(jp)
    assert len(ours.stages) == len(jp.stages) == 22
    assert sum(st.ntrees for st in ours.stages) == 2135
    for a, b, j in zip(ours.stages, conv.stages, jp.stages):
        _assert_same(a, b)
        assert a.threshold == j.threshold == np.float32(j.threshold)
        for f in ("feat_rects", "weights", "thr", "left_leaf", "right_leaf"):
            np.testing.assert_array_equal(getattr(a, f), getattr(j, f))
    tab = ours.device_table("cpu")
    assert tuple(tab["records"].shape) == (2135, 48)
    assert tab["stage_start"].tolist()[-1] == 2135


def test_synth_frames_match_the_golden():
    with open(os.path.join(DATA, "smoke_golden_1080p.json")) as f:
        golden = json.load(f)
    for g in golden["frames"]:
        frame = synth_frame(g["k"], golden["height"], golden["width"])
        assert hashlib.sha256(frame.tobytes()).hexdigest() == g["sha256"]
        assert len(g["rects_mn3"]) > 0 and len(g["rects_mn0"]) > len(g["rects_mn3"])


def test_upperbody_golden_frames_and_cascade():
    with open(os.path.join(DATA, "smoke_golden_upperbody_1080p.json")) as f:
        golden = json.load(f)
    assert golden["cascade"] == "haarcascade_upperbody.xml"
    assert [g["k"] for g in golden["frames"]] == [0, 1]
    for g in golden["frames"]:
        frame = synth_frame(g["k"], golden["height"], golden["width"])
        assert hashlib.sha256(frame.tobytes()).hexdigest() == g["sha256"]
        assert len(g["rects_mn3"]) > 0 and len(g["rects_mn0"]) > len(g["rects_mn3"])


def test_port_imports_without_jax():
    """With jax made unimportable, every module of the port and every
    import of chip_smoke.py still load."""
    code = (
        "import sys, importlib, pkgutil, ast\n"
        "sys.modules['jax'] = None\n"
        "import cascadeclassifier_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "tree = ast.parse(open('chip_smoke.py').read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        for a in node.names: importlib.import_module(a.name)\n"
        "    elif isinstance(node, ast.ImportFrom) and node.level == 0:\n"
        "        mod = importlib.import_module(node.module)\n"
        "        for a in node.names: getattr(mod, a.name)\n"
        "import chip_smoke\n"
        "for m in ('detect.stage', 'detect.tilted', 'detect.packed_front', 'detect.engine', 'utils.golden',\n"
        "          'train.trainer', 'train.split', 'utils.train_data'):\n"
        "    assert 'cascadeclassifier_tpu_torch.' + m in sys.modules, m\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'cascadeclassifier_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr


def test_vec_copy_matches_original(tmp_path):
    from cascadeclassifier_tpu.data import vec as jvec
    from cascadeclassifier_tpu_torch.data import vec

    s = np.random.default_rng(4).integers(0, 256, (7, 24, 24)).astype(np.uint8)
    vec.write_vec(str(tmp_path / "a.vec"), s)
    jvec.write_vec(str(tmp_path / "b.vec"), s)
    assert (tmp_path / "a.vec").read_bytes() == (tmp_path / "b.vec").read_bytes()
    np.testing.assert_array_equal(vec.read_vec(str(tmp_path / "b.vec"), 24, 24),
                                  jvec.read_vec(str(tmp_path / "a.vec"), 24, 24))


def test_negreader_copy_matches_original(tmp_path):
    from cascadeclassifier_tpu.data import negreader as jnegreader
    from cascadeclassifier_tpu_torch.data import negreader
    from cascadeclassifier_tpu_torch.utils.train_data import background, write_pgm

    names = []
    for k, (h, w) in enumerate(((70, 90), (48, 130))):
        names.append(str(tmp_path / f"bg{k}.pgm"))
        write_pgm(names[-1], background(h, w, seed=k))
    (tmp_path / "bg.txt").write_text("\n".join(names) + "\n")
    bg = str(tmp_path / "bg.txt")
    ours, theirs = negreader.NegReader(bg, 20, 20), jnegreader.NegReader(bg, 20, 20)
    np.testing.assert_array_equal(ours.take_batch(150), theirs.take_batch(150))
    assert (ours.last, ours.round, ours.point, ours.scale) == (
        theirs.last, theirs.round, theirs.point, theirs.scale)


@pytest.mark.parametrize("mode", ["BASIC", "CORE", "ALL"])
def test_haar_catalog_copy_matches_original(mode):
    from cascadeclassifier_tpu.ops import features as jfeatures
    from cascadeclassifier_tpu_torch.ops import features

    a, b = features.haar_catalog(20, 16, mode), jfeatures.haar_catalog(20, 16, mode)
    for f in ("rects", "weights", "tilted"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.win_w, a.win_h, a.mode) == (b.win_w, b.win_h, b.mode)


def test_resize_np_copy_matches_original():
    from cascadeclassifier_tpu.ops import resize as jresize
    from cascadeclassifier_tpu_torch.ops import resize

    src = np.random.default_rng(2).integers(0, 256, (97, 131)).astype(np.uint8)
    for dw, dh in ((131, 97), (92, 69), (200, 150), (24, 24)):
        np.testing.assert_array_equal(resize.resize_linear_exact_np(src, dw, dh),
                                      jresize.resize_linear_exact_np(src, dw, dh))


def test_xml_writer_copy_matches_original(tmp_path):
    m = xml_io.read_cascade_xml(VENDORED)
    jm = jxml_io.read_cascade_xml(VENDORED)
    for name, ours, theirs in (
        ("cascade", lambda p: xml_io.write_cascade_xml(m, p),
         lambda p: jxml_io.write_cascade_xml(jm, p)),
        ("params", lambda p: xml_io.write_params_xml(m, p), lambda p: jxml_io.write_params_xml(jm, p)),
        ("stage3", lambda p: xml_io.write_stage_xml(m.stages[3], False, p, "stage3"),
         lambda p: jxml_io.write_stage_xml(jm.stages[3], False, p, "stage3")),
        ("legacy", lambda p: xml_io.write_legacy_haar_xml(m, p),
         lambda p: jxml_io.write_legacy_haar_xml(jm, p)),
    ):
        ours(str(tmp_path / f"{name}_a.xml"))
        theirs(str(tmp_path / f"{name}_b.xml"))
        assert (tmp_path / f"{name}_a.xml").read_bytes() == (tmp_path / f"{name}_b.xml").read_bytes()
    _assert_same(xml_io.read_stage_xml(str(tmp_path / "stage3_a.xml"), 0), m.stages[3])
