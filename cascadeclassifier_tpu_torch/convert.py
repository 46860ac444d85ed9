"""Carry state from the JAX package into the port.

Both functions read only the numpy attributes of the JAX package's
objects, so this module imports no jax: the caller hands over objects it
already built (the tests do, to run both packages on the same cascade and
geometry).
"""

from __future__ import annotations

import numpy as np

from cascadeclassifier_tpu_torch.detect.detector import PackedCascade, PackedStage
from cascadeclassifier_tpu_torch.detect.pyramid import PyramidPlan
from cascadeclassifier_tpu_torch.models.model import FEATURE_HAAR


def from_jax_packed(packed) -> PackedCascade:
    """``cascadeclassifier_tpu.detect.detector.PackedCascade`` → the port's
    ``PackedCascade`` (stump Haar, upright and tilted)."""
    if packed.feature_type != FEATURE_HAAR:
        raise NotImplementedError("the port runs Haar cascades only")
    stages = []
    for st in packed.stages:
        if st.deep_trees is not None:
            raise NotImplementedError("deep-tree cascades are not ported yet")
        stages.append(PackedStage(
            threshold=np.float32(st.threshold),
            ntrees=int(st.ntrees),
            feat_rects=np.asarray(st.feat_rects, np.int32),
            weights=np.asarray(st.weights, np.float32),
            tilted=np.asarray(st.tilted, bool),
            thr=np.asarray(st.thr, np.float32),
            left_leaf=np.asarray(st.left_leaf, np.float32),
            right_leaf=np.asarray(st.right_leaf, np.float32),
        ))
    return PackedCascade(win_w=int(packed.win_w), win_h=int(packed.win_h), stages=stages)


def plan_from_jax(plan) -> PyramidPlan:
    """A ``cascadeclassifier_tpu.detect.pyramid.PyramidPlan``, plain stack
    or shelf-packed → the port's ``PyramidPlan`` (the fields the port
    uses, ``is_top`` and the shelf-packed fields among them)."""
    return PyramidPlan(
        **{f: getattr(plan, f) for f in PyramidPlan.__dataclass_fields__}
    )
