"""Training-side Haar evaluation: all samples × a block of features.

Counterpart of ``cascadeclassifier_tpu/train/evaluators.py::
HaarTrainEvaluator``. Each rectangle sum is a ±1 4-corner functional of
the flattened integral image, so a block of features is a corner
incidence matrix (B, P) and its responses one f32 product with the
(P, N) integral rows, then a division by the norm factor (0 where the
factor is 0: a division, as CvHaarEvaluator computes it, not the
detector's multiply by its inverse). At 24×24 every partial sum is an
integer below 2^24, so the product is exact in any order; TF32 stays off.

LBP and HOG training evaluators are not ported: make_evaluator raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch.models.model import FEATURE_HAAR
from cascadeclassifier_tpu_torch.ops.features import HAAR_BASIC, HaarCatalog, haar_catalog
from cascadeclassifier_tpu_torch.ops.integral import (
    integral_image,
    integral_sq,
    integral_tilted,
    window_norm_factor,
)

_SIGN = (1.0, -1.0, -1.0, 1.0)


def f32_matmul(a, b):
    """a @ b in true f32 (TF32 off for the call)."""
    if a.device.type != "cuda":
        return a @ b
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def corner_matrix(offsets, weights, p: int):
    """(B, 3, 4) corner offsets and (B, 3) weights (tensors) → (B, P) f32
    incidence matrix; coinciding corners add (small integers: exact)."""
    b = offsets.shape[0]
    dev = offsets.device
    sign = torch.tensor(_SIGN, dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev).repeat_interleave(12)
    cols = offsets.reshape(-1).long()
    vals = (weights[:, :, None] * sign[None, None, :]).reshape(-1)
    m = torch.zeros((b, p), dtype=torch.float32, device=dev)
    return m.index_put_((rows, cols), vals, accumulate=True)


def haar_rows(x):
    """(N, h, w) uint8 windows → (sum rows (N, P) f32, norm factors (N,)
    f32): the per-sample state of CvHaarEvaluator::setImage."""
    s = integral_image(x)
    nf = window_norm_factor(s, integral_sq(x, dtype=torch.int32))
    return s.reshape(s.shape[0], -1).to(torch.float32), nf


def divide_nf(raw, nf):
    """raw (B, N) / nf (N,), 0 where nf == 0."""
    nfb = nf[None, :]
    return torch.where(nfb != 0.0, raw / torch.where(nfb == 0.0, 1.0, nfb), 0.0)


class HaarTrainEvaluator:
    """Haar responses of cached sample batches, block by block
    (CvHaarEvaluator, haarfeatures.h:108-122: Σ wᵢ·rectsumᵢ / normfactor,
    0 when normfactor == 0)."""

    def __init__(self, catalog: HaarCatalog, block_size: int = 32768, device="cuda"):
        self.catalog = catalog
        self.block_size = block_size
        self.device = torch.device(device)
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        self.need_tilted = bool(catalog.tilted.any())
        self._offsets = torch.from_numpy(catalog.corner_offsets()).to(self.device)
        self._weights = torch.from_numpy(catalog.weights).to(self.device)
        self._tilted = torch.from_numpy(catalog.tilted).to(self.device)
        self.num_features = len(catalog)
        self.n = 0

    def set_samples(self, samples):
        """samples: (N, h, w) uint8 → caches integral rows + norm factors."""
        x = torch.as_tensor(samples).to(self.device)
        self.sum_rows, self.nf = haar_rows(x)
        if self.need_tilted:
            t = integral_tilted(x)
            self.tilt_rows = t.reshape(t.shape[0], -1).to(torch.float32)
        self.n = int(x.shape[0])

    def num_blocks(self):
        return (self.num_features + self.block_size - 1) // self.block_size

    def block_slice(self, b):
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.num_features)

    def corner_matrices(self, sel):
        """(upright (B, P), tilted (B, P) or None) for the features sel."""
        off, w, til = self._offsets[sel], self._weights[sel], self._tilted[sel]
        if not bool(til.any()):
            return corner_matrix(off, w, self.p), None
        up = ~til
        return (corner_matrix(off * up[:, None, None], w * up[:, None], self.p),
                corner_matrix(off * til[:, None, None], w * til[:, None], self.p))

    def _eval_features(self, sel):
        m_up, m_tilt = self.corner_matrices(sel)
        raw = f32_matmul(m_up, self.sum_rows.T)
        if m_tilt is not None:
            raw = raw + f32_matmul(m_tilt, self.tilt_rows.T)
        return divide_nf(raw, self.nf)

    def values_block(self, b: int):
        """(B, N) f32 responses of feature block b on the cached samples."""
        lo, hi = self.block_slice(b)
        return self._eval_features(slice(lo, hi))

    def values_for_vars(self, var_ids):
        """(K, N) responses of an explicit list of feature indices."""
        ids = torch.as_tensor(np.asarray(var_ids, np.int64), device=self.device)
        return self._eval_features(ids)


def make_evaluator(feature_type, win_w, win_h, haar_mode=HAAR_BASIC, device="cuda"):
    if feature_type == FEATURE_HAAR:
        return HaarTrainEvaluator(haar_catalog(win_w, win_h, haar_mode), device=device)
    raise NotImplementedError(
        "the port trains Haar cascades only: the LBP and HOG training evaluators "
        "are not ported"
    )
