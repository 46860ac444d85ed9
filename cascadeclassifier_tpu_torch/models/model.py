"""Cascade model intermediate representation (numpy only).

A copy of ``cascadeclassifier_tpu.models.model``: the port cannot import
the JAX package, whose ``__init__`` imports jax. Dataclasses mirror the
on-disk ``cascade.xml`` schema that OpenCV's runtime detector consumes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

FEATURE_HAAR, FEATURE_LBP, FEATURE_HOG = 0, 1, 2
FEATURE_TYPE_NAMES = {FEATURE_HAAR: "HAAR", FEATURE_LBP: "LBP", FEATURE_HOG: "HOG"}
FEATURE_TYPE_IDS = {v: k for k, v in FEATURE_TYPE_NAMES.items()}

BOOST_DAB, BOOST_RAB, BOOST_LB, BOOST_GAB = 0, 1, 2, 3
BOOST_TYPE_NAMES = {BOOST_DAB: "DAB", BOOST_RAB: "RAB", BOOST_LB: "LB", BOOST_GAB: "GAB"}
BOOST_TYPE_IDS = {v: k for k, v in BOOST_TYPE_NAMES.items()}


@dataclasses.dataclass
class HaarFeature:
    """Up to 3 weighted rects + tilted flag."""

    rects: List[tuple]  # [(x, y, w, h, weight), ...] length 1..3
    tilted: bool = False


@dataclasses.dataclass
class LBPFeature:
    """Top-left cell rect of the 3×3 LBP grid."""

    rect: tuple  # (x, y, cell_w, cell_h)


@dataclasses.dataclass
class HOGFeature:
    """Cell-0 rect + descriptor component index."""

    rect: tuple  # (x, y, cell_w, cell_h)
    component: int = 0  # 0..35: cellIdx*9 + binIdx


@dataclasses.dataclass
class WeakTree:
    """One weak classifier in BFS ``internalNodes``/``leafValues`` layout.

    For each internal node i (BFS order):
      left[i]  : child code — positive = internal-node index, <=0 = leaf
                 index ``-left[i]`` into leaf_values
      right[i] : same
      feature_idx[i] : index into the cascade's compacted feature list
      threshold[i]   : ordered-split cut, or
      subsets[i]     : (subset_n,) int32 bitmask for categorical splits
    """

    left: np.ndarray  # (K,) int32
    right: np.ndarray  # (K,) int32
    feature_idx: np.ndarray  # (K,) int32
    threshold: Optional[np.ndarray] = None  # (K,) float32 (ordered)
    subsets: Optional[np.ndarray] = None  # (K, subset_n) int32 (categorical)
    leaf_values: np.ndarray = None  # (K+1,) float32

    @property
    def num_nodes(self):
        return int(self.left.shape[0])


@dataclasses.dataclass
class Stage:
    threshold: float
    trees: List[WeakTree]

    @property
    def weak_count(self):
        return len(self.trees)


@dataclasses.dataclass
class CascadeModel:
    """A full cascade: params + stages + compacted feature list."""

    feature_type: int  # FEATURE_HAAR / FEATURE_LBP / FEATURE_HOG
    width: int
    height: int
    stages: List[Stage]
    features: list  # List[HaarFeature|LBPFeature|HOGFeature]
    stage_type: str = "BOOST"
    boost_type: int = BOOST_GAB
    min_hit_rate: float = 0.995
    max_false_alarm: float = 0.5
    weight_trim_rate: float = 0.95
    max_depth: int = 1
    max_weak_count: int = 100
    max_cat_count: int = 0
    feat_size: int = 1
    haar_mode: str = "BASIC"

    @property
    def num_stages(self):
        return len(self.stages)

    def uses_tilted(self) -> bool:
        return self.feature_type == FEATURE_HAAR and any(
            f.tilted for f in self.features
        )

    def max_tree_nodes(self) -> int:
        return max(
            (t.num_nodes for s in self.stages for t in s.trees), default=0
        )

    def validate(self):
        nfeat = len(self.features)
        for si, s in enumerate(self.stages):
            for t in s.trees:
                if t.feature_idx.min() < 0 or t.feature_idx.max() >= nfeat:
                    raise ValueError(f"stage {si}: feature index out of range")
                if t.leaf_values.shape[0] < 1:
                    raise ValueError(f"stage {si}: tree without leaves")
                if self.max_cat_count > 0:
                    if t.subsets is None:
                        raise ValueError(f"stage {si}: categorical tree without subsets")
                elif t.threshold is None or t.threshold.shape != (t.num_nodes,):
                    raise ValueError(f"stage {si}: ordered tree without thresholds")
        return self
