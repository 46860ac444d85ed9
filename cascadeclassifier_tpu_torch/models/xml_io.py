"""OpenCV-FileStorage cascade XML reader (numpy only).

A copy of the reading half of ``cascadeclassifier_tpu.models.xml_io``:
the modern ``cascade.xml`` format (params, stages, compacted features)
and the legacy ``opencv-haar-classifier`` format. Writing XML is not
ported yet.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from cascadeclassifier_tpu_torch.models.model import (
    BOOST_TYPE_IDS,
    FEATURE_HAAR,
    FEATURE_LBP,
    FEATURE_TYPE_IDS,
    CascadeModel,
    HaarFeature,
    HOGFeature,
    LBPFeature,
    Stage,
    WeakTree,
)

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
