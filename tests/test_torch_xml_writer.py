"""The port's XML writer (models/xml_io.py) byte for byte against the JAX
package's writer, mirroring tests/test_xml_io.py: every vendored and
installed OpenCV cascade, the synthetic deep-tree and categorical models,
the params.xml / stage%d.xml checkpoints and the legacy Haar format; each
written file reads back to the model."""

import dataclasses
import os

import numpy as np
import pytest

from cascadeclassifier_tpu.models import model as jmodel  # noqa: E402
from cascadeclassifier_tpu.models import xml_io as jxml_io  # noqa: E402
from cascadeclassifier_tpu_torch.models import model  # noqa: E402
from cascadeclassifier_tpu_torch.models import xml_io  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "cascadeclassifier_tpu_torch", "data")
CASCADES = "/usr/share/opencv4/haarcascades"
VENDORED = ["haarcascade_frontalface_alt.xml", "haarcascade_frontalface_alt2.xml",
            "haarcascade_eye_tree_eyeglasses.xml", "haarcascade_upperbody.xml",
            "lbpcascade_frontalface.xml"]
INSTALLED = ["haarcascade_frontalface_default.xml", "haarcascade_frontalface_alt_tree.xml",
             "haarcascade_lefteye_2splits.xml", "haarcascade_profileface.xml",
             "haarcascade_smile.xml"]


def _assert_same(a, b, path="model"):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _both_write(tmp_path, write_ours, write_theirs):
    ours, theirs = str(tmp_path / "ours.xml"), str(tmp_path / "theirs.xml")
    write_ours(ours)
    write_theirs(theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    return ours


def _reads_back(out, m):
    """out reads back to m's stages and features (the stage parameters
    come back as the f32 the file holds, as the JAX reader gives them)."""
    back = xml_io.read_cascade_xml(out)
    _assert_same(back.stages, m.stages)
    _assert_same(back.features, m.features)
    jback = jxml_io.read_cascade_xml(out)
    for f in ("min_hit_rate", "max_false_alarm", "weight_trim_rate", "max_depth",
              "max_weak_count", "max_cat_count", "haar_mode", "width", "height"):
        assert getattr(back, f) == getattr(jback, f), f


def _cascade_case(tmp_path, path):
    m, jm = xml_io.read_cascade_xml(path), jxml_io.read_cascade_xml(path)
    out = _both_write(tmp_path, lambda p: xml_io.write_cascade_xml(m, p),
                      lambda p: jxml_io.write_cascade_xml(jm, p))
    _reads_back(out, m)


@pytest.mark.parametrize("name", VENDORED)
def test_write_vendored_cascade_like_original(tmp_path, name):
    _cascade_case(tmp_path, os.path.join(DATA, name))


@pytest.mark.parametrize("name", INSTALLED)
def test_write_installed_cascade_like_original(tmp_path, name):
    path = os.path.join(CASCADES, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not installed")
    _cascade_case(tmp_path, path)


def _tiny(mod, categorical=False):
    """tests/test_xml_io.py::_tiny_model, built from mod's classes."""
    if categorical:
        trees = [mod.WeakTree(left=np.array([0], np.int32), right=np.array([-1], np.int32),
                              feature_idx=np.array([0], np.int32),
                              subsets=np.array([[0x0F0F, -1, 3, 0, 0, 0, 0, 0]], np.int32),
                              leaf_values=np.array([-0.5, 0.75], np.float32))]
        return mod.CascadeModel(feature_type=mod.FEATURE_LBP, width=24, height=24,
                                stages=[mod.Stage(threshold=-0.3, trees=trees)],
                                features=[mod.LBPFeature(rect=(1, 2, 3, 4))], max_cat_count=256)
    trees = [mod.WeakTree(left=np.array([1, 0, -1], np.int32),
                          right=np.array([2, -2, -3], np.int32),
                          feature_idx=np.array([0, 1, 0], np.int32),
                          threshold=np.array([0.5, -1.25, 3.0], np.float32),
                          leaf_values=np.array([0.1, -0.2, 0.3, -0.4], np.float32))]
    return mod.CascadeModel(
        feature_type=mod.FEATURE_HAAR, width=24, height=24,
        stages=[mod.Stage(threshold=0.82, trees=trees),
                mod.Stage(threshold=1.0 / 3.0, trees=trees)],
        features=[mod.HaarFeature(rects=[(0, 0, 4, 4, -1.0), (2, 0, 2, 4, 2.0)]),
                  mod.HaarFeature(rects=[(1, 1, 6, 3, -1.0), (1, 2, 6, 1, 3.0)], tilted=True)],
        max_depth=2, min_hit_rate=0.999, weight_trim_rate=0.9, haar_mode="ALL")


@pytest.mark.parametrize("categorical", [False, True])
def test_write_synthetic_model_like_original(tmp_path, categorical):
    m, jm = _tiny(model, categorical), _tiny(jmodel, categorical)
    out = _both_write(tmp_path, lambda p: xml_io.write_cascade_xml(m, p),
                      lambda p: jxml_io.write_cascade_xml(jm, p))
    _reads_back(out, m)


@pytest.mark.parametrize("categorical", [False, True])
def test_checkpoints_like_original(tmp_path, categorical):
    m, jm = _tiny(model, categorical), _tiny(jmodel, categorical)
    out = _both_write(tmp_path, lambda p: xml_io.write_params_xml(m, p, node_name="params"),
                      lambda p: jxml_io.write_params_xml(jm, p, node_name="params"))
    p, jp = xml_io.read_params_xml(out), jxml_io.read_params_xml(out)
    assert p.stages == [] and p.feature_type == m.feature_type and p.haar_mode == m.haar_mode
    for f in ("min_hit_rate", "max_false_alarm", "weight_trim_rate", "max_depth",
              "max_weak_count", "max_cat_count", "feat_size", "boost_type"):
        assert getattr(p, f) == getattr(jp, f), f
    cat = 256 if categorical else 0
    for i, (st, jst) in enumerate(zip(m.stages, jm.stages)):
        out = _both_write(tmp_path, lambda p: xml_io.write_stage_xml(st, categorical, p, f"stage{i}"),
                          lambda p: jxml_io.write_stage_xml(jst, categorical, p, f"stage{i}"))
        _assert_same(xml_io.read_stage_xml(out, cat), jxml_io.read_stage_xml(out, cat))
        _assert_same(xml_io.read_stage_xml(out, cat), st)


@pytest.mark.parametrize("source", ["tiny", "haarcascade_frontalface_alt.xml",
                                    "haarcascade_eye_tree_eyeglasses.xml"])
def test_legacy_haar_like_original(tmp_path, source):
    if source == "tiny":
        m, jm = _tiny(model), _tiny(jmodel)
    else:
        path = os.path.join(DATA, source)
        m, jm = xml_io.read_cascade_xml(path), jxml_io.read_cascade_xml(path)
    out = _both_write(tmp_path, lambda p: xml_io.write_legacy_haar_xml(m, p),
                      lambda p: jxml_io.write_legacy_haar_xml(jm, p))
    back = xml_io.read_cascade_xml(out)
    assert back.num_stages == m.num_stages
    for s1, s2 in zip(back.stages, m.stages):
        assert s1.threshold == s2.threshold
        for t1, t2 in zip(s1.trees, s2.trees):  # nodes come back in queue order
            np.testing.assert_array_equal(np.sort(t1.threshold), np.sort(t2.threshold))
            assert sorted(back.features[i].rects for i in t1.feature_idx) == \
                sorted(m.features[i].rects for i in t2.feature_idx)


def test_legacy_format_is_haar_only(tmp_path):
    with pytest.raises(ValueError):
        xml_io.write_legacy_haar_xml(_tiny(model, True), str(tmp_path / "x.xml"))
