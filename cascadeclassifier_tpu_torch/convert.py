"""Carry state from the JAX package into the port.

Every function reads only the numpy attributes of the JAX package's
objects, so this module imports no jax: the caller hands over objects it
already built (the tests do, to run both packages on the same cascade and
geometry).
"""

from __future__ import annotations

import numpy as np

from cascadeclassifier_tpu_torch.detect.detector import PackedCascade, PackedStage
from cascadeclassifier_tpu_torch.detect.pyramid import PyramidPlan
from cascadeclassifier_tpu_torch.models.model import (
    HaarFeature,
    LBPFeature,
    Stage,
    WeakTree,
)


def _array(a, dtype):
    return None if a is None else np.array(a, dtype)


def _feature(f):
    """A JAX package feature → the port's HaarFeature or LBPFeature (by
    its attributes: Haar features have rects, LBP features one rect)."""
    if hasattr(f, "rects"):
        return HaarFeature(rects=[tuple(r) for r in f.rects], tilted=bool(f.tilted))
    return LBPFeature(rect=tuple(int(v) for v in f.rect))


def _tree(t):
    return WeakTree(
        left=_array(t.left, np.int32), right=_array(t.right, np.int32),
        feature_idx=_array(t.feature_idx, np.int32),
        threshold=_array(t.threshold, np.float32), subsets=_array(t.subsets, np.int32),
        leaf_values=_array(t.leaf_values, np.float32),
    )


def from_jax_packed(packed) -> PackedCascade:
    """``cascadeclassifier_tpu.detect.detector.PackedCascade`` → the port's
    ``PackedCascade``: Haar (stumps and node trees, upright and tilted)
    and LBP (stumps and node trees); the JAX package packs no HOG cascade
    (its detect CLI sends one to HOGDetector, the port's TorchDetector to
    ``detect/hog_detector.py``)."""
    stages = []
    for st in packed.stages:
        deep = None
        if st.deep_trees is not None:
            deep = [(_tree(t), [_feature(f) for f in feats]) for t, feats in st.deep_trees]
        stages.append(PackedStage(
            threshold=np.float32(st.threshold),
            ntrees=int(st.ntrees),
            feat_rects=np.asarray(st.feat_rects, np.int32),
            weights=np.asarray(st.weights, np.float32),
            tilted=np.asarray(st.tilted, bool),
            thr=np.asarray(st.thr, np.float32),
            left_leaf=np.asarray(st.left_leaf, np.float32),
            right_leaf=np.asarray(st.right_leaf, np.float32),
            subsets=_array(st.subsets, np.int32),
            lbp_rects=_array(st.lbp_rects, np.int32),
            deep_trees=deep,
        ))
    return PackedCascade(win_w=int(packed.win_w), win_h=int(packed.win_h), stages=stages,
                         feature_type=int(packed.feature_type))


def plan_from_jax(plan) -> PyramidPlan:
    """A ``cascadeclassifier_tpu.detect.pyramid.PyramidPlan``, plain stack
    or shelf-packed → the port's ``PyramidPlan`` (the fields the port
    uses, ``is_top`` and the shelf-packed fields among them)."""
    return PyramidPlan(
        **{f: getattr(plan, f) for f in PyramidPlan.__dataclass_fields__}
    )


def stages_from_jax(stages) -> list:
    """A JAX trainer's ``stages`` (``Stage`` objects with global feature
    indices) → the port's, for a port trainer or predictor to start from."""
    return [Stage(threshold=float(s.threshold), trees=[_tree(t) for t in s.trees])
            for s in stages]


def boost_params_from_jax(params):
    """``cascadeclassifier_tpu.train.boost.BoostParams`` → the port's."""
    from cascadeclassifier_tpu_torch.train.boost import BoostParams

    return BoostParams(**{f: getattr(params, f) for f in BoostParams.__dataclass_fields__})


def trainer_from_jax(trainer, device="cuda"):
    """A JAX ``CascadeTrainer`` → a port ``CascadeTrainer`` with the same
    window, Haar mode, boosting parameters, budgets, mining batch and
    stages, on device."""
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer

    ours = CascadeTrainer(
        feature_type=int(trainer.feature_type), win_w=int(trainer.win_w),
        win_h=int(trainer.win_h), haar_mode=int(trainer.haar_mode),
        boost=boost_params_from_jax(trainer.boost), mining_batch=int(trainer.mining_batch),
        precalc_val_mb=trainer.precalc_val_mb, precalc_idx_mb=trainer.precalc_idx_mb,
        device=device,
    )
    ours.stages = stages_from_jax(trainer.stages)
    return ours
