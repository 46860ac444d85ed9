"""Multi-scale detector for HOG-feature cascades.

Counterpart of ``cascadeclassifier_tpu/detect/hog_detector.py``. The
OpenCV runtime never detected with HOG cascades (the reference trains them
only), so the semantics are the JAX package's own, crop-consistent with
training: every candidate window is evaluated exactly as a training sample
(per-window gradient histograms with replicated borders at the window
edge), through the training predictor.

Per pyramid level: the exact INTER_LINEAR_EXACT resize on the device
(``ops/resize.py::build_level``), the windows on the level's ystep grid
(rows ``range((h + 1 − win_h) // step)·step``, as the JAX package takes
them), the predictor in batches (``hog_hist`` and ``hog_eval`` kernels on
a CUDA device, then the stump or node walk), one fetch per frame; then
the cvRound mapping with the f64 factor, ``group_rectangles`` and
``clip_rects``. A frame is a span ``detect.frame`` (``utils/profiling.py``),
its raw windows ``detect.raw_windows``, and each phase a span of its own:
``hog.plan`` (the pyramid plan and the frame's upload), ``hog.resize``
and ``hog.predict`` (a level each), ``hog.fetch``, ``hog.map``,
``hog.group``; none synchronizes.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from cascadeclassifier_tpu_torch.detect.grouping import clip_rects, group_rectangles
from cascadeclassifier_tpu_torch.detect.pyramid import build_plan
from cascadeclassifier_tpu_torch.models.model import FEATURE_HOG, CascadeModel
from cascadeclassifier_tpu_torch.ops.features import HOG_FEAT_SIZE, hog_catalog
from cascadeclassifier_tpu_torch.ops.resize import build_level
from cascadeclassifier_tpu_torch.train.evaluators import HOGTrainEvaluator
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count, span


def stages_with_global_vars(model: CascadeModel) -> list:
    """The model's stages with each node's compacted feature index mapped
    back to its catalog variable f·36 + component."""
    cat = hog_catalog(model.width, model.height)
    rect_to_fi = {tuple(int(v) for v in cat.rects[i]): i for i in range(len(cat))}
    stages = copy.deepcopy(model.stages)
    for s in stages:
        for t in s.trees:
            for ni in range(t.num_nodes):
                f = model.features[int(t.feature_idx[ni])]
                t.feature_idx[ni] = rect_to_fi[tuple(f.rect)] * HOG_FEAT_SIZE + f.component
    return stages


class HOGDetector:
    """detectMultiScale for HOG cascades (crop-consistent semantics) on
    ``device`` ("cuda" unless the caller asks for the CPU); impl="ref"
    takes the kernels' plain versions there."""

    def __init__(self, model: CascadeModel, batch: int = 8192, device="cuda",
                 impl: str = "auto"):
        if model.feature_type != FEATURE_HOG:
            raise ValueError("HOGDetector takes HOG cascades")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        self.model = model
        self.batch = batch
        self._ev = HOGTrainEvaluator(hog_catalog(model.width, model.height), device=self.device,
                                     impl=impl)
        self._pred = CascadePredictor(lambda: self._ev, stages_with_global_vars(model))

    def raw_windows(self, img: np.ndarray, scale_factor: float = 1.1, min_size=None,
                    max_size=None):
        """(candidate rects (N, 4) int64 in image coordinates, before
        grouping, in level and grid order; the number of windows
        evaluated)."""
        img = np.ascontiguousarray(img)
        if img.ndim != 2 or img.dtype != np.uint8:
            raise ValueError("expected a 2-D uint8 frame")
        with span("detect.raw_windows"):
            return self._raw_windows(img, scale_factor, min_size, max_size)

    def _raw_windows(self, img, scale_factor, min_size, max_size):
        h, w = img.shape
        ww, wh = self.model.width, self.model.height
        with span("hog.plan"):
            plan = build_plan(w, h, ww, wh, scale_factor,
                              tuple(min_size) if min_size else None,
                              tuple(max_size) if max_size else None)
            count(SYNC)
            frame = torch.from_numpy(img).to(self.device)
        levels, oks, n_windows = [], [], 0
        for s, f in enumerate(plan.scales):
            sw, sh = int(plan.scaled_w[s]), int(plan.scaled_h[s])
            step = int(plan.ystep[s])
            ny, nx = (sh + 1 - wh) // step, len(range(0, sw - ww + 1, step))
            if sw < ww or sh < wh or ny <= 0 or nx <= 0:
                continue
            with span("hog.resize"):
                scaled = build_level(frame, h, w, sh, sw, 0, 0, sh, sw)
                grid = scaled.unfold(0, wh, step).unfold(1, ww, step)[:ny, :nx]
                grid = grid.reshape(-1, wh, ww)
            with span("hog.predict"):
                for lo in range(0, grid.shape[0], self.batch):
                    oks.append(self._pred.predict_device(grid[lo:lo + self.batch]))
            levels.append((s, ny, nx))
            n_windows += ny * nx
        with span("hog.fetch"):
            count(SYNC)
            ok = torch.cat(oks).cpu().numpy() if oks else np.zeros(0, bool)
        with span("hog.map"):
            rects, off = [np.zeros((0, 4), np.int64)], 0
            for s, ny, nx in levels:
                gy, gx = np.nonzero(ok[off:off + ny * nx].reshape(ny, nx))
                off += ny * nx
                step, fx = int(plan.ystep[s]), np.float64(plan.scales[s])
                r = np.empty((len(gy), 4), np.int64)
                r[:, 0] = np.rint(gx * step * fx)
                r[:, 1] = np.rint(gy * step * fx)
                r[:, 2], r[:, 3] = int(plan.box_w[s]), int(plan.box_h[s])
                rects.append(r)
            rects = np.concatenate(rects)
        return rects, n_windows

    def detect_multi_scale(self, img: np.ndarray, scale_factor: float = 1.1,
                           min_neighbors: int = 3, min_size=None, max_size=None) -> np.ndarray:
        """(N, 4) rects (x, y, w, h): the candidates grouped unclipped, then
        clipped, as detectMultiScale orders them."""
        with span("detect.frame"):
            rects, _ = self.raw_windows(img, scale_factor, min_size, max_size)
            h, w = img.shape
            with span("hog.group"):
                return clip_rects(group_rectangles(rects, min_neighbors), w, h)
