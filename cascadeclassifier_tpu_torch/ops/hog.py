"""HOG integral histograms and responses (kernels 11 and 12).

``hog_integral_histogram`` is the counterpart of
``cascadeclassifier_tpu/ops/features.py::hog_integral_histogram``
(CvHOGEvaluator::integralHistogram, HOGfeatures.cpp:163-256):
central-difference gradients with replicated borders, the magnitude
sqrt(gx² + gy²), the orientation bin floor(ang·9/π − 0.5) mod 9 of the
atan2 angle moved into [0, 2π), and the integral images of the magnitude
per bin and in total. ``hog_responses`` is the counterpart of the
training evaluator's cell sums and block norms
(``cascadeclassifier_tpu/train/evaluators.py:296-310``) and of
``eval_hog`` (features.py:578): for each variable f·36 + cell·9 + bin, the
bin's sum over the cell divided by the block's L1 norm plus 1e-3, 0 where
the sum is not above 1e-3 (CvHOGEvaluator::operator(), HOGfeatures.h:
84-108). A CUDA tensor runs ``csrc/hog_hist.cu`` and ``csrc/hog_eval.cu``;
a CPU tensor, or ``impl="ref"``, runs the plain version. Each kernel takes
a plan: ``hist_plan`` (the channel group that fits the shared-memory
budget, threads), built here, and the variables grouped by
feature, which ``hog_eval.cu`` builds on the device (no host sync) and
``eval_plan`` is the plain version of; the CPU tests hold both.

The bits are the JAX package's where its order is fixed:

- gx and gy are integers in [−255, 255], so the bin is a function of the
  pair: ``bin_table`` holds it for all 511² pairs, computed once in f32
  on the host with torch's atan2 (the JAX package's bin for every pair,
  tests/test_torch_hog.py), and both versions read it;
- gx² + gy² is an exact integer below 2^24 and its square root is taken
  correctly rounded, as XLA:CPU takes it (torch's f32 sqrt on the CPU is
  not: the plain version takes it in f64);
- each integral is ``jnp.cumsum`` along W and then along H, which
  XLA:CPU adds in blocks of 16 plus the blocks' prefix
  (``train/split.py::scan_cumsum``), from 0.

A cell sum is ((p0 − p1) − p2) + p3 of its four corners, as ``eval_hog``
adds them; the block norm the same of cell 0's p0, cell 1's p1, cell 2's
p2 and cell 3's p3. The JAX evaluator takes both as an f32 matrix product
whose order of adds depends on the shapes (Eigen's blocking of the
contraction), so its responses may differ from these in the last bits
(ROADMAP C.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.ops.features import HOG_FEAT_SIZE, N_BINS
from cascadeclassifier_tpu_torch.train.split import scan_cumsum

GRAD_RANGE = 511  # gx, gy in [-255, 255]
HOG_EPS = np.float32(1e-3)
MAX_SIDE = 256  # hog_hist.cu scans a row or column in at most two levels of 16
MAX_SHARED = 227 * 1024  # a CTA's shared memory on the H100
CHANNELS = N_BINS + 1  # the 9 bins' integrals, then the norm's
# hog_hist.cu's plan (utils/tune_hog.py times others): one window a CTA
# and as many of its 10 channels as fit HIST_BUDGET bytes, which keeps 4
# CTAs on an SM; a thread takes two row or column chains
HIST_BUDGET = 56 * 1024
MAX_THREADS = 1024
SLACK = 4  # hog_hist.cu's kSlack: floats a run may shift to match its destination
EVAL_DIRECT_MAX = 64  # hog_eval.cu's kDirectMax: shorter lists take no plan, no scratch
# hog_eval.cu's point(k, c): the point of the block's 3x3 corner grid that
# is cell k's corner c; and GRID_CORNER, the first (cell·4 + corner) at each point
GRID_POINT = np.array([[(k // 2 + c // 2) * 3 + k % 2 + c % 2 for c in range(4)]
                       for k in range(4)])
GRID_CORNER = np.array([GRID_POINT.reshape(-1).tolist().index(q) for q in range(9)])

_BIN_TABLES: dict = {}


def bin_table(device) -> torch.Tensor:
    """(511·511,) uint8: the orientation bin of (gx, gy) at (gx + 255)·511 +
    gy + 255, built once on the host in f32 and copied to device."""
    device = torch.device(device)
    if device not in _BIN_TABLES:
        g = torch.arange(-255, 256, dtype=torch.float32)
        gx, gy = g[:, None].expand(GRAD_RANGE, GRAD_RANGE), g[None, :].expand(GRAD_RANGE,
                                                                               GRAD_RANGE)
        ang = torch.atan2(gy, gx)
        ang = torch.where(ang < 0, ang + np.float32(2 * np.pi), ang)
        b = torch.floor(ang * np.float32(N_BINS / np.pi) - np.float32(0.5)).to(torch.int32)
        b = torch.where(b < 0, b + N_BINS, b)
        b = torch.where(b >= N_BINS, b - N_BINS, b)
        _BIN_TABLES[device] = b.to(torch.uint8).reshape(-1).to(device)
    return _BIN_TABLES[device]


@dataclasses.dataclass(frozen=True)
class HistPlan:
    """A hog_hist launch: a CTA a window, the 10 channels in groups of
    ``channels`` (a grid row a group), ``threads`` a CTA; each plane (h+1)
    rows of ``stride`` floats (odd) in ``shared`` bytes."""

    channels: int
    threads: int
    stride: int
    shared: int

    def groups(self):
        """[(first channel, end)] of the grid's rows."""
        return [(c, min(CHANNELS, c + self.channels)) for c in range(0, CHANNELS, self.channels)]


def shared_bytes(channels: int, plane: int) -> int:
    """hog_hist.cu's shared_floats in bytes: the planes, then kSlack floats
    for each of the two runs."""
    return 4 * (channels * plane + 2 * SLACK)


def hist_plan(h: int, w: int) -> HistPlan:
    """The plan of hog_hist at (h, w): the most channels whose planes fit
    HIST_BUDGET, at least one (a plane fits MAX_SHARED for every size the
    wrapper takes); a thread for two row or column chains of the larger
    pass, in whole warps."""
    stride = w + 1 if (w + 1) % 2 else w + 2
    plane = (h + 1) * stride
    c = CHANNELS
    while c > 1 and shared_bytes(c, plane) > HIST_BUDGET:
        c -= 1
    threads = min(MAX_THREADS, -(-c * max(h, w) // 64) * 32)
    return HistPlan(c, threads, stride, shared_bytes(c, plane))


def is_corner_grid(cells) -> bool:
    """Whether each feature's corner offsets (F, 4, 4) form a 2x2 grid of
    cells, neighbours sharing their corners, as hog_eval.cu reads them."""
    flat = np.asarray(cells).reshape(-1, 16)
    return bool((flat == flat[:, GRID_CORNER][:, GRID_POINT.reshape(-1)]).all())


def eval_plan(var_ids, n_features: int):
    """Plain version of hog_eval.cu's plan, the grouping of var_ids (K,)
    int64 by feature: (the ids sorted; each sorted id's position in
    var_ids; starts (n_features + 1,) int64, feature f's ids at [starts[f],
    starts[f+1]) of the sorted list). The kernel's plan orders a feature's
    ids as its atomics fall; no output depends on that order."""
    ids, order = torch.sort(var_ids, stable=True)
    bounds = torch.arange(0, (n_features + 1) * HOG_FEAT_SIZE, HOG_FEAT_SIZE,
                          device=var_ids.device)
    return ids, order, torch.searchsorted(ids, bounds)


def gradients(img):
    """(N, H, W) uint8 → (gx, gy) int32, central differences with
    replicated borders."""
    x = img.to(torch.int32)
    h, w = x.shape[1:]
    dev = x.device
    cols = torch.arange(w, device=dev)
    rows = torch.arange(h, device=dev)
    gx = x[:, :, (cols + 1).clamp(max=w - 1)] - x[:, :, (cols - 1).clamp(min=0)]
    gy = x[:, (rows + 1).clamp(max=h - 1)] - x[:, (rows - 1).clamp(min=0)]
    return gx, gy


def _integral(v):
    """Inclusive sums along W, then along H, in scan_cumsum's order, with
    a zero row and column in front."""
    s = scan_cumsum(v.movedim(-1, 0)).movedim(0, -1)
    s = scan_cumsum(s.movedim(-2, 0)).movedim(0, -2)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def hog_integral_histogram_ref(img):
    """Plain version: (N, H, W) uint8 → (hist (N, 9, H+1, W+1) f32, norm
    (N, H+1, W+1) f32)."""
    gx, gy = gradients(img)
    mag = torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(torch.float32)
    b = bin_table(img.device)[((gx + 255) * GRAD_RANGE + gy + 255).long()]
    onehot = b[:, None] == torch.arange(N_BINS, device=img.device, dtype=torch.uint8)[
        None, :, None, None]
    per_bin = torch.where(onehot, mag[:, None], 0.0)
    return _integral(per_bin), _integral(mag)


def hog_integral_histogram(img, impl: str = "auto"):
    """(N, H, W) uint8 → (hist (N, 9, H+1, W+1) f32, norm (N, H+1, W+1)
    f32)."""
    if img.dim() != 3:
        raise ValueError(f"hog_integral_histogram: expected (N, H, W), got {tuple(img.shape)}")
    if _build.use_ref(img, impl):
        return hog_integral_histogram_ref(img)
    dev = img.device
    _build.require(img, torch.uint8, 3, "img", dev)
    n, h, w = img.shape
    # the wrapper's sizes: 5 bytes a pixel within a CTA's shared memory (a
    # plane of every one of them fits a CTA, tests/test_torch_hog.py)
    if not (0 < h <= MAX_SIDE and 0 < w <= MAX_SIDE and 5 * h * w <= MAX_SHARED):
        raise ValueError(f"hog_hist: sides of at most {MAX_SIDE} and {MAX_SHARED // 5} "
                         f"pixels, got {h}x{w}")
    plan = hist_plan(h, w)
    hist = torch.empty((n, N_BINS, h + 1, w + 1), dtype=torch.float32, device=dev)
    norm = torch.empty((n, h + 1, w + 1), dtype=torch.float32, device=dev)
    code = _build.lib().cct_hog_hist(img.data_ptr(), bin_table(dev).data_ptr(), n, h, w,
                                     plan.channels, plan.threads, hist.data_ptr(),
                                     norm.data_ptr(), _build.stream_of(img))
    _build.check(code, "cct_hog_hist")
    _build.LAUNCHES["hog_hist"] += 1
    return hist, norm


def _corners(x):
    return ((x[..., 0] - x[..., 1]) - x[..., 2]) + x[..., 3]


def hog_responses_ref(hist, norm, cells, var_ids):
    """Plain version: hist (N, 9, P) f32, norm (N, P) f32, cells (F, 4, 4)
    int32 corner offsets, var_ids (K,) int64 → (K, N) f32."""
    f = var_ids // HOG_FEAT_SIZE
    cell = var_ids % HOG_FEAT_SIZE // N_BINS
    b = var_ids % N_BINS
    off = cells[f, cell].long()  # (K, 4)
    cs = _corners(hist[:, b[:, None], off])  # (N, K)
    diag = torch.arange(4, device=cells.device)
    nr = _corners(norm[:, cells[f][:, diag, diag].long()])
    eps = torch.tensor(HOG_EPS, device=hist.device)
    return torch.where(cs > eps, cs / (nr + eps), 0.0).t().contiguous()


def hog_responses(hist, norm, cells, var_ids, impl: str = "auto"):
    """hist (N, 9, P) f32, norm (N, P) f32, cells (F, 4, 4) int32 corner
    offsets, each feature's a 2x2 grid of cells (``is_corner_grid``, as
    ``HOGCatalog.cell_corner_offsets`` builds them; the kernel reads each
    shared corner once and does not check), var_ids (K,) int64 (var =
    f·36 + cell·9 + bin, 0 ≤ var < 36F; any order, repeats allowed) → (K,
    N) f32."""
    if _build.use_ref(hist, impl):
        return hog_responses_ref(hist, norm, cells, var_ids)
    dev = hist.device
    _build.require(hist, torch.float32, 3, "hist", dev)
    _build.require(norm, torch.float32, 2, "norm", dev)
    _build.require(cells, torch.int32, 3, "cells", dev)
    _build.require(var_ids, torch.int64, 1, "var_ids", dev)
    n, nb, p = hist.shape
    if nb != N_BINS or norm.shape != (n, p) or tuple(cells.shape[1:]) != (4, 4):
        raise ValueError(f"hog_eval: shapes {tuple(hist.shape)}, {tuple(norm.shape)}, "
                         f"{tuple(cells.shape)}")
    k, nf = var_ids.shape[0], cells.shape[0]
    # the plan's scratch, for a list longer than EVAL_DIRECT_MAX (kept until
    # the launch is queued)
    scratch = (torch.empty(2 * nf + 1 + 2 * k, dtype=torch.int32, device=dev)
               if k > EVAL_DIRECT_MAX else None)
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    code = _build.lib().cct_hog_eval(hist.data_ptr(), norm.data_ptr(), cells.data_ptr(),
                                     var_ids.data_ptr(), n, p, nf, k,
                                     None if scratch is None else scratch.data_ptr(),
                                     out.data_ptr(), _build.stream_of(hist))
    _build.check(code, "cct_hog_eval")
    _build.LAUNCHES["hog_eval"] += 1
    return out
