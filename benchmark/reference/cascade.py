"""OpenCV cascade XML (the modern format) as plain numpy arrays.

The benchmark's own reader: it shares no code with the program under
test. It takes what both cells need, upright Haar features under
stump trees (a tree of one internal node), and refuses anything else.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass
class Stage:
    threshold: float  # as written in the XML (the runtime takes it as f32)
    feature: np.ndarray  # (T,) int64 index into Cascade.rects
    split: np.ndarray  # (T,) float32 node threshold
    left: np.ndarray  # (T,) float32 leaf where value < / <= split
    right: np.ndarray  # (T,) float32


@dataclasses.dataclass
class Cascade:
    win_w: int
    win_h: int
    stages: list
    rects: np.ndarray  # (F, 3, 4) int64 x, y, w, h (zeros where absent)
    weights: np.ndarray  # (F, 3) float32 (0 where absent)

    @property
    def n_trees(self) -> int:
        return sum(len(s.feature) for s in self.stages)


def _nums(text: str) -> list:
    return text.split()


def _child(node, tag):
    c = node.find(tag)
    if c is None:
        raise ValueError(f"cascade XML: <{node.tag}> has no <{tag}>")
    return c


def read_cascade(path: str) -> Cascade:
    """Parse a modern-format Haar cascade (OpenCV's shipped files and the
    trainer's cascade.xml)."""
    root = ET.parse(path).getroot()
    node = list(root)[0]
    if node.get("type_id") == "opencv-haar-classifier":
        raise ValueError("the legacy Haar format is not read here")
    if _child(node, "featureType").text.strip() != "HAAR":
        raise ValueError("only Haar cascades are read here")
    win_w = int(_child(node, "width").text)
    win_h = int(_child(node, "height").text)
    stages = []
    for s in _child(node, "stages").findall("_"):
        feat, split, left, right = [], [], [], []
        for t in _child(s, "weakClassifiers").findall("_"):
            nodes = _nums(_child(t, "internalNodes").text)
            leaves = _nums(_child(t, "leafValues").text)
            if len(nodes) != 4 or len(leaves) != 2:
                raise ValueError("only stump trees are read here")
            if int(nodes[0]) != 0 or int(nodes[1]) != -1:
                raise ValueError("unexpected stump layout")
            feat.append(int(nodes[2]))
            split.append(np.float32(float(nodes[3])))
            left.append(np.float32(float(leaves[0])))
            right.append(np.float32(float(leaves[1])))
        stages.append(Stage(
            threshold=float(_child(s, "stageThreshold").text),
            feature=np.asarray(feat, np.int64), split=np.asarray(split, np.float32),
            left=np.asarray(left, np.float32), right=np.asarray(right, np.float32)))
    feats = _child(node, "features").findall("_")
    rects = np.zeros((len(feats), 3, 4), np.int64)
    weights = np.zeros((len(feats), 3), np.float32)
    for i, f in enumerate(feats):
        tilted = f.find("tilted")
        if tilted is not None and int(tilted.text) != 0:
            raise ValueError("tilted features are not read here")
        for j, r in enumerate(_child(f, "rects").findall("_")):
            v = _nums(r.text)
            rects[i, j] = [int(v[0]), int(v[1]), int(v[2]), int(v[3])]
            weights[i, j] = np.float32(float(v[4]))
    return Cascade(win_w=win_w, win_h=win_h, stages=stages, rects=rects, weights=weights)


def exact_f64_sums(c: Cascade) -> bool:
    """Whether every stage's f64 sum of its f32 leaves is exact in any
    order: every partial sum fits in 53 bits above the smallest leaf's
    last bit. Then a reduction in any order equals the runtime's sum in
    tree order, bit for bit."""
    for s in c.stages:
        leaves = np.concatenate([s.left, s.right]).astype(np.float64)
        nz = np.abs(leaves[leaves != 0])
        if nz.size == 0:
            continue
        lsb = np.min(np.ldexp(1.0, np.frexp(nz)[1] - 24))
        bound = np.sum(np.maximum(np.abs(s.left), np.abs(s.right)).astype(np.float64))
        if bound >= lsb * 2.0 ** 52:
            return False
    return True


def write_cascade(c: Cascade, path: str):
    """Write a stump Haar cascade in the modern format ``read_cascade``
    reads (the fields it reads, doubles as %.16e)."""
    out = ["<?xml version=\"1.0\"?>", "<opencv_storage>",
           "<cascade type_id=\"opencv-cascade-classifier\">",
           "<stageType>BOOST</stageType>", "<featureType>HAAR</featureType>",
           f"<height>{c.win_h}</height>", f"<width>{c.win_w}</width>",
           f"<stageNum>{len(c.stages)}</stageNum>", "<stages>"]
    for s in c.stages:
        out += ["<_>", f"<maxWeakCount>{len(s.feature)}</maxWeakCount>",
                f"<stageThreshold>{float(s.threshold):.16e}</stageThreshold>", "<weakClassifiers>"]
        for f, t, a, b in zip(s.feature, s.split, s.left, s.right):
            out.append(f"<_><internalNodes>0 -1 {int(f)} {float(t):.16e}</internalNodes>"
                       f"<leafValues>{float(a):.16e} {float(b):.16e}</leafValues></_>")
        out += ["</weakClassifiers>", "</_>"]
    out += ["</stages>", "<features>"]
    for r, w in zip(c.rects, c.weights):
        rs = "".join(f"<_>{x} {y} {rw} {rh} {float(wt):.1f}</_>"
                     for (x, y, rw, rh), wt in zip(r, w) if wt != 0)
        out.append(f"<_><rects>{rs}</rects></_>")
    out += ["</features>", "</cascade>", "</opencv_storage>"]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
