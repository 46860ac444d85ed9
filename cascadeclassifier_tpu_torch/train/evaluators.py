"""Training-side Haar, LBP and HOG evaluation: all samples × a block of features.

Counterpart of ``cascadeclassifier_tpu/train/evaluators.py::
HaarTrainEvaluator``. Each rectangle sum is a ±1 4-corner functional of
the flattened integral image, so a block of features is a corner
incidence matrix (B, P) and its responses one f32 product with the
(P, N) integral rows, then a division by the norm factor (0 where the
factor is 0: a division, as CvHaarEvaluator computes it, not the
detector's multiply by its inverse). At 24×24 every partial sum is an
integer below 2^24, so the product is exact in any order; TF32 stays off.

LBP codes take the 9 cell sums of each feature the same way, a ±1 corner
matrix (9·B, P) times the f32 integral rows (exact: integers below 2^24),
then the 8 compares of ``lbp_code_grid``.

HOG responses are 36 a feature (var = f·36 + cell·9 + bin): the per-sample
integral histograms of ``ops/hog.py::hog_integral_histogram`` and the
gathered cell sums over block norms of ``ops/hog.py::hog_responses``
(kernels on a CUDA tensor, their plain versions on a CPU one).
"""

from __future__ import annotations

import numpy as np
import torch

from cascadeclassifier_tpu_torch.models.model import FEATURE_HAAR, FEATURE_HOG, FEATURE_LBP
from cascadeclassifier_tpu_torch.ops.features import (
    HAAR_BASIC,
    HOG_FEAT_SIZE,
    HaarCatalog,
    HOGCatalog,
    LBPCatalog,
    haar_catalog,
    hog_catalog,
    lbp_catalog,
    lbp_code_grid,
)
from cascadeclassifier_tpu_torch.ops.hog import (
    hog_integral_histogram,
    hog_responses,
    is_corner_grid,
)
from cascadeclassifier_tpu_torch.ops.integral import (
    integral_image,
    integral_sq,
    integral_tilted,
    window_norm_factor,
)
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count

_SIGN = (1.0, -1.0, -1.0, 1.0)


def _upload(a, device, dtype=None):
    """a as a tensor on device: a host array's blocking upload is a sync
    site; a tensor (the callers' are on the device already) is not."""
    if not torch.is_tensor(a):
        count(SYNC)
    return torch.as_tensor(a, dtype=dtype, device=device)


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
    """(B, R, 4) corner offsets and (B, R) weights of R rectangles a row
    (tensors) → (B, P) f32 incidence matrix; coinciding corners add (small
    integers: exact)."""
    b, r = offsets.shape[:2]
    dev = offsets.device
    count(SYNC)
    sign = torch.tensor(_SIGN, dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev).repeat_interleave(4 * r)
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

    maxCatCount = 0  # ordered features

    def __init__(self, catalog: HaarCatalog, block_size: int = 32768, device="cuda"):
        self.catalog = catalog
        self.block_size = block_size
        self.device = torch.device(device)
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        self.need_tilted = bool(catalog.tilted.any())
        count(SYNC, 3)
        self._offsets = torch.from_numpy(catalog.corner_offsets()).to(self.device)
        self._weights = torch.from_numpy(catalog.weights).to(self.device)
        self._tilted = torch.from_numpy(catalog.tilted).to(self.device)
        self.num_features = self.var_count = len(catalog)
        self.n = 0

    def set_samples(self, samples):
        """samples: (N, h, w) uint8 → caches integral rows + norm factors."""
        x = _upload(samples, self.device)
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
        count(SYNC)
        if not bool(til.any()):
            return corner_matrix(off, w, self.p), None
        up = ~til
        return (corner_matrix(off * up[:, None, None], w * up[:, None], self.p),
                corner_matrix(off * til[:, None, None], w * til[:, None], self.p))

    def kernel_records(self, sel):
        """Records of the features sel for the dense miner (csrc/mine.cu):
        corner offsets (B, 3, 4) int32 into the flattened (h+1)×(w+1)
        integral (the tilted one for a tilted feature), weights (B, 3)
        int32 (0: no rect), tilted flags (B,) int32."""
        w = self._weights[sel]
        count(SYNC)
        if not torch.equal(w, w.round()):
            raise ValueError("Haar weights are not integers: the miner sums rects in integers")
        return (self._offsets[sel].to(torch.int32).contiguous(), w.to(torch.int32).contiguous(),
                self._tilted[sel].to(torch.int32).contiguous())

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
        ids = _upload(np.asarray(var_ids, np.int64), self.device)
        return self._eval_features(ids)


def lbp_rows(x):
    """(N, h, w) uint8 windows → (N, P) f32 integral rows (the per-sample
    state of CvLBPEvaluator::setImage)."""
    s = integral_image(x)
    return s.reshape(s.shape[0], -1).to(torch.float32)


class LBPTrainEvaluator:
    """LBP codes (0..255) of cached sample batches, block by block
    (CvLBPEvaluator, lbpfeatures.h:70-83): the 9 cell sums of a block of
    features are one (9·B, P) × (P, N) product, then 8 compares."""

    maxCatCount = 256  # categorical features

    def __init__(self, catalog: LBPCatalog, block_size: int = 16384, device="cuda"):
        self.catalog = catalog
        self.block_size = block_size
        self.device = torch.device(device)
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        count(SYNC, 2)
        self._cell_rects = torch.from_numpy(catalog.cell_rects()).to(self.device)
        self._cell_points = torch.from_numpy(catalog.cell_offsets()).to(self.device)
        self.num_features = self.var_count = len(catalog)
        self.n = 0

    def set_samples(self, samples):
        """samples: (N, h, w) uint8 → caches the integral rows."""
        x = _upload(samples, self.device)
        self.sum_rows = lbp_rows(x)
        self.n = int(x.shape[0])

    def num_blocks(self):
        return (self.num_features + self.block_size - 1) // self.block_size

    def block_slice(self, b):
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.num_features)

    def cell_matrix(self, sel):
        """(9·B, P) cell incidence matrix of the features sel."""
        cells = self._cell_rects[sel].reshape(-1, 1, 4)
        return corner_matrix(cells, cells.new_ones(cells.shape[:2], dtype=torch.float32), self.p)

    def kernel_records(self, sel):
        """(B, 16) int32: the 4×4 corner grid points of the features sel,
        row-major, for the dense miner (csrc/mine.cu)."""
        return self._cell_points[sel].to(torch.int32).contiguous()

    @staticmethod
    def codes(m, rows):
        """Cell matrix m (9·B, P) and integral rows (N, P) → (B, N) int32."""
        cs = f32_matmul(m, rows.T).view(m.shape[0] // 9, 3, 3, rows.shape[0])
        return lbp_code_grid([[cs[:, r, c] for c in range(3)] for r in range(3)])

    def values_block(self, b: int):
        """(B, N) int32 codes of feature block b on the cached samples."""
        lo, hi = self.block_slice(b)
        return self.codes(self.cell_matrix(slice(lo, hi)), self.sum_rows)

    def values_for_vars(self, var_ids):
        """(K, N) int32 codes of an explicit list of feature indices."""
        ids = _upload(np.asarray(var_ids, np.int64), self.device)
        return self.codes(self.cell_matrix(ids), self.sum_rows)


class HOGTrainEvaluator:
    """HOG descriptor components (36 variables a feature) of cached sample
    batches, block by block (CvHOGEvaluator, HOGfeatures.h:84-108): a bin's
    sum over a cell of the per-bin integral histograms, over the block's L1
    norm. Variable blocks hold whole features (block_size % 36 == 0)."""

    maxCatCount = 0
    featSize = HOG_FEAT_SIZE

    def __init__(self, catalog: HOGCatalog, block_size: int = HOG_FEAT_SIZE * 1024,
                 device="cuda", impl: str = "auto"):
        """impl="ref" takes the kernels' plain versions on any device."""
        if block_size % HOG_FEAT_SIZE:
            raise ValueError(f"block_size must be a multiple of 36, got {block_size}")
        self.catalog = catalog
        self.block_size = block_size
        self.device = torch.device(device)
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        self.num_features = len(catalog)
        self.var_count = catalog.var_count
        cells = catalog.cell_corner_offsets()
        if not is_corner_grid(cells):
            raise ValueError("HOG catalog: a feature's cells are not a 2x2 grid")
        count(SYNC)
        self._cells = torch.from_numpy(cells).to(self.device)
        self.impl = impl
        self.n = 0

    def set_samples(self, samples):
        """samples: (N, h, w) uint8 → caches the integral histograms."""
        x = _upload(samples, self.device)
        hist, norm = hog_integral_histogram(x, impl=self.impl)
        n = int(x.shape[0])
        self.hist_rows = hist.reshape(n, 9, -1)
        self.norm_rows = norm.reshape(n, -1)
        self.n = n

    def num_blocks(self):
        return (self.var_count + self.block_size - 1) // self.block_size

    def block_slice(self, b):
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.var_count)

    def values_block(self, b: int):
        """(B, N) f32 responses of variable block b on the cached samples."""
        lo, hi = self.block_slice(b)
        return self.values_for_vars(torch.arange(lo, hi, device=self.device))

    def values_for_vars(self, var_ids):
        """(K, N) responses of an explicit list of variable indices."""
        ids = _upload(var_ids, self.device, torch.int64)
        return hog_responses(self.hist_rows, self.norm_rows, self._cells, ids, impl=self.impl)


def make_evaluator(feature_type, win_w, win_h, haar_mode=HAAR_BASIC, device="cuda"):
    if feature_type == FEATURE_HAAR:
        return HaarTrainEvaluator(haar_catalog(win_w, win_h, haar_mode), device=device)
    if feature_type == FEATURE_LBP:
        return LBPTrainEvaluator(lbp_catalog(win_w, win_h), device=device)
    if feature_type == FEATURE_HOG:
        return HOGTrainEvaluator(hog_catalog(win_w, win_h), device=device)
    raise ValueError(f"unknown feature type {feature_type}")
