"""LBP codes (plain PyTorch).

A copy of ``cascadeclassifier_tpu/ops/features.py::lbp_code_grid``: the
port cannot import the JAX package.
"""

from __future__ import annotations

import torch

# (row, col, bit) of the 8 outer cells: 128 at the top left, then clockwise
# around the centre (CvLBPEvaluator::Feature::calc)
LBP_BITS = ((0, 0, 128), (0, 1, 64), (0, 2, 32), (1, 2, 16),
            (2, 2, 8), (2, 1, 4), (2, 0, 2), (1, 0, 1))


def lbp_code_grid(cs):
    """3×3 grid of cell-sum tensors (row-major, any uniform shape) → LBP
    code tensor (int32): each outer cell sets its bit when its sum is
    >= the centre's. cs: indexable as cs[r][c]."""
    cval = cs[1][1]
    code = None
    for r, c, bit in LBP_BITS:
        t = torch.where(cs[r][c] >= cval, bit, 0).to(torch.int32)
        code = t if code is None else code | t
    return code
