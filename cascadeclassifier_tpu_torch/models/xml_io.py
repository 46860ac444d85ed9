"""OpenCV-FileStorage cascade XML I/O (numpy only).

A copy of ``cascadeclassifier_tpu.models.xml_io``, reading and writing
the on-disk formats of the reference trainer:

  - modern ``cascade.xml`` (cascadeclassifier.cpp:439-456 — params,
    stageNum, stages[], compacted features[])
  - legacy "-baseFormatSave" Haar-only format (cascadeclassifier.cpp:457-530)
  - ``params.xml`` checkpoint header (cascadeclassifier.cpp:248-261)
  - per-stage ``stage%d.xml`` checkpoints with *global* feature indices
    (cascadeclassifier.cpp:262-275)

The writer mimics OpenCV FileStorage XML conventions (``<opencv_storage>``
root, ``<_>`` anonymous sequence entries, ``%.16e`` float formatting with a
trailing dot for integral values) so files load in OpenCV's C++
``cv::CascadeClassifier`` unchanged; its output is byte-identical to the
JAX package's writer.
"""

from __future__ import annotations

import io
import re
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from cascadeclassifier_tpu_torch.models.model import (
    BOOST_TYPE_IDS,
    BOOST_TYPE_NAMES,
    FEATURE_HAAR,
    FEATURE_LBP,
    FEATURE_TYPE_IDS,
    FEATURE_TYPE_NAMES,
    CascadeModel,
    HaarFeature,
    HOGFeature,
    LBPFeature,
    Stage,
    WeakTree,
)

# ---------------------------------------------------------------------------
# formatting helpers (OpenCV FileStorage conventions)
# ---------------------------------------------------------------------------


def _fmt_float(v: float) -> str:
    """Format a float the way OpenCV FileStorage does.

    Integral values get a trailing dot ("-1.", "2."); everything else is
    written as %.16e (e.g. "8.2268941402435303e-01")."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return f"{int(f)}."
    return f"{f:.16e}"


def _fmt_num(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return _fmt_float(v)


class _W:
    """Tiny indented XML writer (OpenCV-FileStorage look-alike)."""

    def __init__(self):
        self.buf = io.StringIO()
        self.depth = 0

    def line(self, s):
        self.buf.write("  " * self.depth + s + "\n")

    def open(self, tag, attrs=""):
        self.line(f"<{tag}{attrs}>")
        self.depth += 1

    def close(self, tag):
        self.depth -= 1
        self.line(f"</{tag}>")

    def scalar(self, tag, value):
        self.line(f"<{tag}>{_fmt_num(value)}</{tag}>")

    def text(self, tag, value):
        self.line(f"<{tag}>{value}</{tag}>")

    def numseq(self, tag, values, per_line=12):
        vals = [_fmt_num(v) for v in values]
        self.open(tag)
        for i in range(0, len(vals), per_line):
            self.line(" ".join(vals[i : i + per_line]))
        self.close(tag)

    def getvalue(self):
        return self.buf.getvalue()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _write_stage_params(w: _W, m: CascadeModel):
    w.open("stageParams")
    w.text("boostType", BOOST_TYPE_NAMES[m.boost_type])
    # the reference stores these two as C floats (boost.h:37-54)
    w.scalar("minHitRate", float(np.float32(m.min_hit_rate)))
    w.scalar("maxFalseAlarm", float(np.float32(m.max_false_alarm)))
    w.scalar("weightTrimRate", float(m.weight_trim_rate))
    w.scalar("maxDepth", int(m.max_depth))
    w.scalar("maxWeakCount", int(m.max_weak_count))
    w.close("stageParams")


def _write_feature_params(w: _W, m: CascadeModel):
    w.open("featureParams")
    w.scalar("maxCatCount", int(m.max_cat_count))
    w.scalar("featSize", int(m.feat_size))
    if m.feature_type == FEATURE_HAAR:
        w.text("mode", m.haar_mode)
    w.close("featureParams")


def _write_params(w: _W, m: CascadeModel):
    """cascadeParams + stageParams + featureParams (writeParams,
    cascadeclassifier.cpp:359-364)."""
    w.text("stageType", m.stage_type)
    w.text("featureType", FEATURE_TYPE_NAMES[m.feature_type])
    w.scalar("height", int(m.height))
    w.scalar("width", int(m.width))
    _write_stage_params(w, m)
    _write_feature_params(w, m)


def _tree_internal_nodes(tree: WeakTree, categorical: bool) -> list:
    out = []
    for i in range(tree.num_nodes):
        out.append(int(tree.left[i]))
        out.append(int(tree.right[i]))
        out.append(int(tree.feature_idx[i]))
        if categorical:
            out.extend(int(s) for s in np.asarray(tree.subsets[i], np.int32))
        else:
            out.append(float(tree.threshold[i]))
    return out


def _write_stage(w: _W, stage: Stage, categorical: bool):
    """CvCascadeBoost::write (boost.cpp:520-532)."""
    w.scalar("maxWeakCount", stage.weak_count)
    w.scalar("stageThreshold", float(stage.threshold))
    w.open("weakClassifiers")
    for tree in stage.trees:
        w.open("_")
        w.numseq("internalNodes", _tree_internal_nodes(tree, categorical))
        w.numseq("leafValues", [float(v) for v in tree.leaf_values])
        w.close("_")
    w.close("weakClassifiers")


def _write_features(w: _W, m: CascadeModel):
    w.open("features")
    for f in m.features:
        w.open("_")
        if isinstance(f, HaarFeature):
            w.open("rects")
            for (x, y, rw, rh, wt) in f.rects:
                w.open("_")
                w.line(f"{x} {y} {rw} {rh} {_fmt_float(wt)}")
                w.close("_")
            w.close("rects")
            w.scalar("tilted", 1 if f.tilted else 0)
        elif isinstance(f, LBPFeature):
            x, y, rw, rh = f.rect
            w.open("rect")
            w.line(f"{x} {y} {rw} {rh}")
            w.close("rect")
        elif isinstance(f, HOGFeature):
            x, y, rw, rh = f.rect
            w.open("rect")
            w.line(f"{x} {y} {rw} {rh} {f.component}")
            w.close("rect")
        else:
            raise TypeError(type(f))
        w.close("_")
    w.close("features")


def write_cascade_xml(m: CascadeModel, path: str, node_name: str = "cascade"):
    """Write the modern cascade.xml format (cascadeclassifier.cpp:446-456)."""
    w = _W()
    w.line('<?xml version="1.0"?>')
    w.open("opencv_storage")
    w.open(node_name, ' type_id="opencv-cascade-classifier"')
    _write_params(w, m)
    w.scalar("stageNum", m.num_stages)
    w.open("stages")
    categorical = m.max_cat_count > 0
    for i, stage in enumerate(m.stages):
        w.line(f"<!-- stage {i} -->")
        w.open("_")
        _write_stage(w, stage, categorical)
        w.close("_")
    w.close("stages")
    _write_features(w, m)
    w.close(node_name)
    w.close("opencv_storage")
    with open(path, "w") as fh:
        fh.write(w.getvalue())


def write_params_xml(m: CascadeModel, path: str, node_name: str = "params"):
    """Checkpoint header (params.xml, cascadeclassifier.cpp:248-261)."""
    w = _W()
    w.line('<?xml version="1.0"?>')
    w.open("opencv_storage")
    w.open(node_name)
    _write_params(w, m)
    w.close(node_name)
    w.close("opencv_storage")
    with open(path, "w") as fh:
        fh.write(w.getvalue())


def write_stage_xml(
    stage: Stage, categorical: bool, path: str, node_name: str
):
    """Per-stage checkpoint (stage%d.xml) with global feature indices
    (cascadeclassifier.cpp:262-275)."""
    w = _W()
    w.line('<?xml version="1.0"?>')
    w.open("opencv_storage")
    w.open(node_name)
    _write_stage(w, stage, categorical)
    w.close(node_name)
    w.close("opencv_storage")
    with open(path, "w") as fh:
        fh.write(w.getvalue())


def write_legacy_haar_xml(m: CascadeModel, path: str, node_name: str = "cascade"):
    """Legacy '-baseFormatSave' format, Haar only
    (cascadeclassifier.cpp:457-530): per-stage trees serialized as node
    queues with inline feature geometry and left/right node-or-value."""
    if m.feature_type != FEATURE_HAAR:
        raise ValueError("old file format is used for Haar-like features only")
    w = _W()
    w.line('<?xml version="1.0"?>')
    w.open("opencv_storage")
    w.open(node_name, ' type_id="opencv-haar-classifier"')
    w.open("size")
    w.line(f"{m.width} {m.height}")
    w.close("size")
    w.open("stages")
    for stage in m.stages:
        w.open("_")
        w.open("trees")
        for tree in stage.trees:
            w.open("_")
            # BFS queue over internal nodes, matching the reference writer
            order = []  # queue of internal node indices
            order.append(0)
            qi = 0
            node_pos = {0: 0}
            while qi < len(order):
                ni = order[qi]
                for child in (int(tree.left[ni]), int(tree.right[ni])):
                    if child > 0:
                        node_pos[child] = len(order)
                        order.append(child)
                qi += 1
            for ni in order:
                w.open("_")
                f = m.features[int(tree.feature_idx[ni])]
                w.open("feature")
                w.open("rects")
                for (x, y, rw, rh, wt) in f.rects:
                    w.open("_")
                    w.line(f"{x} {y} {rw} {rh} {_fmt_float(wt)}")
                    w.close("_")
                w.close("rects")
                w.scalar("tilted", 1 if f.tilted else 0)
                w.close("feature")
                w.scalar("threshold", float(tree.threshold[ni]))
                lc, rc = int(tree.left[ni]), int(tree.right[ni])
                if lc > 0:
                    w.scalar("left_node", node_pos[lc])
                else:
                    w.scalar("left_val", float(tree.leaf_values[-lc]))
                if rc > 0:
                    w.scalar("right_node", node_pos[rc])
                else:
                    w.scalar("right_val", float(tree.leaf_values[-rc]))
                w.close("_")
            w.close("_")
        w.close("trees")
        w.scalar("stage_threshold", float(stage.threshold))
        w.scalar("parent", m.stages.index(stage) - 1)
        w.scalar("next", -1)
        w.close("_")
    w.close("stages")
    w.close(node_name)
    w.close("opencv_storage")
    with open(path, "w") as fh:
        fh.write(w.getvalue())


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"[-+0-9.eE]+")


def _nums(text: str) -> list:
    return _NUM_RE.findall(text or "")


def _to_num(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _child_text(node, tag, default=None):
    c = node.find(tag)
    if c is None:
        return default
    return (c.text or "").strip()


def _child_num(node, tag, default=None):
    t = _child_text(node, tag)
    if t is None or t == "":
        return default
    return _to_num(t)


def _parse_tree(tnode, max_cat_count: int) -> WeakTree:
    subset_n = (max_cat_count + 31) // 32
    step = 3 + (subset_n if max_cat_count > 0 else 1)
    raw = _nums(tnode.find("internalNodes").text)
    leaf = [float(v) for v in _nums(tnode.find("leafValues").text)]
    k = len(raw) // step
    left = np.zeros(k, np.int32)
    right = np.zeros(k, np.int32)
    fidx = np.zeros(k, np.int32)
    thr = np.zeros(k, np.float32) if max_cat_count == 0 else None
    subs = np.zeros((k, subset_n), np.int32) if max_cat_count > 0 else None
    for i in range(k):
        rec = raw[i * step : (i + 1) * step]
        left[i] = int(rec[0])
        right[i] = int(rec[1])
        fidx[i] = int(rec[2])
        if max_cat_count > 0:
            # subset ints may exceed int32 range as unsigned text; wrap
            subs[i] = np.array(
                [int(v) for v in rec[3:]], dtype=np.int64
            ).astype(np.int32)
        else:
            thr[i] = float(rec[3])
    return WeakTree(
        left=left,
        right=right,
        feature_idx=fidx,
        threshold=thr,
        subsets=subs,
        leaf_values=np.array(leaf, np.float32),
    )


def _parse_stage(snode, max_cat_count: int) -> Stage:
    thr = float(_child_num(snode, "stageThreshold"))
    trees = [
        _parse_tree(t, max_cat_count)
        for t in snode.find("weakClassifiers").findall("_")
    ]
    return Stage(threshold=thr, trees=trees)


def _parse_features(fnode, feature_type: int) -> list:
    feats = []
    for f in fnode.findall("_"):
        if feature_type == FEATURE_HAAR:
            rects = []
            for r in f.find("rects").findall("_"):
                v = _nums(r.text)
                rects.append(
                    (int(v[0]), int(v[1]), int(v[2]), int(v[3]), float(v[4]))
                )
            tilted = bool(int(_child_num(f, "tilted", 0) or 0))
            feats.append(HaarFeature(rects=rects, tilted=tilted))
        elif feature_type == FEATURE_LBP:
            v = _nums(f.find("rect").text)
            feats.append(
                LBPFeature(rect=(int(v[0]), int(v[1]), int(v[2]), int(v[3])))
            )
        else:
            v = _nums(f.find("rect").text)
            feats.append(
                HOGFeature(
                    rect=(int(v[0]), int(v[1]), int(v[2]), int(v[3])),
                    component=int(v[4]),
                )
            )
    return feats


def _read_params_into(node, m: CascadeModel):
    m.stage_type = _child_text(node, "stageType", "BOOST")
    m.feature_type = FEATURE_TYPE_IDS[_child_text(node, "featureType", "HAAR")]
    m.height = int(_child_num(node, "height"))
    m.width = int(_child_num(node, "width"))
    sp = node.find("stageParams")
    if sp is not None:
        bt = _child_text(sp, "boostType")
        if bt:
            m.boost_type = BOOST_TYPE_IDS[bt]
        m.min_hit_rate = float(_child_num(sp, "minHitRate", m.min_hit_rate))
        m.max_false_alarm = float(
            _child_num(sp, "maxFalseAlarm", m.max_false_alarm)
        )
        m.weight_trim_rate = float(
            _child_num(sp, "weightTrimRate", m.weight_trim_rate)
        )
        m.max_depth = int(_child_num(sp, "maxDepth", m.max_depth))
        m.max_weak_count = int(_child_num(sp, "maxWeakCount", m.max_weak_count))
    fp = node.find("featureParams")
    if fp is not None:
        m.max_cat_count = int(_child_num(fp, "maxCatCount", 0) or 0)
        m.feat_size = int(_child_num(fp, "featSize", 1) or 1)
        mode = _child_text(fp, "mode")
        if mode:
            m.haar_mode = mode


def _first_top_node(path: str):
    root = ET.parse(path).getroot()
    if root.tag != "opencv_storage":
        raise ValueError(f"{path}: not an OpenCV storage file")
    children = list(root)
    if not children:
        raise ValueError(f"{path}: empty storage")
    return children[0]


def read_cascade_xml(path: str) -> CascadeModel:
    """Read a modern-format cascade.xml (trainer output or OpenCV-pretrained)."""
    node = _first_top_node(path)
    if node.get("type_id") == "opencv-haar-classifier":
        return _read_legacy_haar(node)
    m = CascadeModel(
        feature_type=FEATURE_HAAR, width=0, height=0, stages=[], features=[]
    )
    _read_params_into(node, m)
    m.stages = [
        _parse_stage(s, m.max_cat_count)
        for s in node.find("stages").findall("_")
    ]
    m.features = _parse_features(node.find("features"), m.feature_type)
    return m.validate()


def _read_legacy_haar(node) -> CascadeModel:
    """Read the legacy opencv-haar-classifier format."""
    size = _nums(node.find("size").text)
    width, height = int(size[0]), int(size[1])
    features: List[HaarFeature] = []
    stages: List[Stage] = []
    for snode in node.find("stages").findall("_"):
        trees = []
        for tnode in snode.find("trees").findall("_"):
            nodes = tnode.findall("_")
            k = len(nodes)
            left = np.zeros(k, np.int32)
            right = np.zeros(k, np.int32)
            fidx = np.zeros(k, np.int32)
            thr = np.zeros(k, np.float32)
            leaves = []
            for i, nd in enumerate(nodes):
                feat = nd.find("feature")
                rects = []
                for r in feat.find("rects").findall("_"):
                    v = _nums(r.text)
                    rects.append(
                        (int(v[0]), int(v[1]), int(v[2]), int(v[3]), float(v[4]))
                    )
                tilted = bool(int(_child_num(feat, "tilted", 0) or 0))
                fidx[i] = len(features)
                features.append(HaarFeature(rects=rects, tilted=tilted))
                thr[i] = float(_child_num(nd, "threshold"))
                ln, lv = _child_num(nd, "left_node"), _child_num(nd, "left_val")
                rn, rv = _child_num(nd, "right_node"), _child_num(nd, "right_val")
                if ln is not None:
                    left[i] = int(ln)
                else:
                    leaves.append(float(lv))
                    left[i] = -(len(leaves) - 1)
                if rn is not None:
                    right[i] = int(rn)
                else:
                    leaves.append(float(rv))
                    right[i] = -(len(leaves) - 1)
            trees.append(
                WeakTree(
                    left=left,
                    right=right,
                    feature_idx=fidx,
                    threshold=thr,
                    leaf_values=np.array(leaves, np.float32),
                )
            )
        stages.append(
            Stage(threshold=float(_child_num(snode, "stage_threshold")), trees=trees)
        )
    return CascadeModel(
        feature_type=FEATURE_HAAR,
        width=width,
        height=height,
        stages=stages,
        features=features,
    ).validate()


def read_params_xml(path: str) -> CascadeModel:
    """Read a params.xml checkpoint header into an empty model."""
    node = _first_top_node(path)
    m = CascadeModel(
        feature_type=FEATURE_HAAR, width=0, height=0, stages=[], features=[]
    )
    _read_params_into(node, m)
    return m


def read_stage_xml(path: str, max_cat_count: int) -> Stage:
    """Read a stage%d.xml checkpoint (global feature indices)."""
    node = _first_top_node(path)
    return _parse_stage(node, max_cat_count)
