"""Multi-scale cascade detector on PyTorch (CUDA or CPU).

Counterpart of ``cascadeclassifier_tpu/detect/detector.py``: the packed
cascade, the exact INTER_LINEAR_EXACT canvas resize, the mapping of
window positions to image rects, and ``TorchDetector``, whose
``detect_multi_scale`` matches cv::CascadeClassifier::detectMultiScale
for stump Haar cascades, upright or tilted, with f32 stage sums.

Runtime semantics replicated:
  - variance gate: reject window unless nf² > 0 and area/nf < 0.1
  - Haar value = f32(Σ wᵢ·rectsumᵢ) · f32(1/√nf²); split: value < threshold
  - stage pass: Σ leaves ≥ f32(stageThreshold) − 1e-5
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cascadeclassifier_tpu_torch.detect.grouping import clip_rects, group_rectangles
from cascadeclassifier_tpu_torch.detect.pyramid import PyramidPlan, build_plan
from cascadeclassifier_tpu_torch.detect.records import tile_pitch, tree_records
from cascadeclassifier_tpu_torch.models.model import FEATURE_HAAR, CascadeModel
from cascadeclassifier_tpu_torch.ops.resize import _axis_tab

THRESHOLD_EPS = np.float32(1e-5)


@dataclasses.dataclass
class PackedStage:
    threshold: np.float32  # effective (xml − 1e-5)
    ntrees: int
    feat_rects: np.ndarray  # (T, 3, 4) int32 rect geometry (x, y, w, h)
    weights: np.ndarray  # (T, 3) float32, 0 for absent rects
    tilted: np.ndarray  # (T,) bool — the tree's feature is a 45° one
    thr: np.ndarray  # (T,) float32
    left_leaf: np.ndarray  # (T,) float32
    right_leaf: np.ndarray  # (T,) float32


@dataclasses.dataclass
class PackedCascade:
    """Stump Haar cascade (upright and tilted features) as flat arrays."""

    win_w: int
    win_h: int
    stages: list
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def has_tilted(self) -> bool:
        return any(st.tilted.any() for st in self.stages)

    @classmethod
    def from_model(cls, m: CascadeModel) -> "PackedCascade":
        if m.feature_type != FEATURE_HAAR:
            raise NotImplementedError("the port runs Haar cascades only")
        if m.max_tree_nodes() > 1:
            raise NotImplementedError("deep-tree cascades are not ported yet")
        stages = []
        for s in m.stages:
            t = len(s.trees)
            fr = np.zeros((t, 3, 4), np.int32)
            w = np.zeros((t, 3), np.float32)
            tl = np.zeros(t, bool)
            thr = np.zeros(t, np.float32)
            ll = np.zeros(t, np.float32)
            rl = np.zeros(t, np.float32)
            for i, tree in enumerate(s.trees):
                f = m.features[int(tree.feature_idx[0])]
                if tree.left[0] <= 0:
                    ll[i] = tree.leaf_values[-int(tree.left[0])]
                if tree.right[0] <= 0:
                    rl[i] = tree.leaf_values[-int(tree.right[0])]
                for ri, (x, y, rw, rh, wt) in enumerate(f.rects):
                    fr[i, ri] = (x, y, rw, rh)
                    w[i, ri] = wt
                tl[i] = f.tilted
                thr[i] = tree.threshold[0]
            stages.append(PackedStage(
                threshold=np.float32(s.threshold) - THRESHOLD_EPS,
                ntrees=t, feat_rects=fr, weights=w, tilted=tl, thr=thr,
                left_leaf=ll, right_leaf=rl,
            ))
        return cls(win_w=m.width, win_h=m.height, stages=stages)

    def __post_init__(self):
        """Every rect's corners lie inside the window, so no kernel read
        leaves the canvas: upright (x, y)..(x+w, y+h); tilted (x, y),
        (x−h, y+h), (x+w, y+w), (x+w−h, y+w+h) (dense.py's assert)."""
        for si, st in enumerate(self.stages):
            x, y, w, h = np.moveaxis(st.feat_rects, -1, 0)
            upright = (x >= 0) & (y >= 0) & (x + w <= self.win_w) & (y + h <= self.win_h)
            tilted = (x - h >= 0) & (y >= 0) & (x + w <= self.win_w) & (y + w + h <= self.win_h)
            inside = np.where(st.tilted[:, None], tilted, upright)
            if not inside.all():
                raise ValueError(f"stage {si}: a rect leaves the {self.win_w}x{self.win_h} window")

    def device_table(self, device) -> dict:
        """Every tree's parameters on the device, built once per device:
        the packed 48-byte tree records (``detect/records.py``) that the
        front and stage kernels read, with the shared-memory pitch they
        are resolved against, and the flat arrays of the packed front."""
        key = str(torch.device(device))
        if key not in self._tables:
            cat = np.concatenate
            st = self.stages
            start = np.concatenate([[0], np.cumsum([s.ntrees for s in st])])

            def dev(a, dt):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

            rec = tree_records(st, self.win_w, self.win_h)
            self._tables[key] = dict(
                records=dev(rec.view(np.uint8).reshape(len(rec), -1), torch.uint8),
                pitch=tile_pitch(self.win_w),
                has_tilted=self.has_tilted,
                rects=dev(cat([s.feat_rects for s in st]), torch.int32),
                weights=dev(cat([s.weights for s in st]), torch.float32),
                tparam=dev(
                    np.stack([cat([s.thr for s in st]),
                              cat([s.left_leaf for s in st]),
                              cat([s.right_leaf for s in st])], axis=1),
                    torch.float32,
                ),
                stage_start=dev(start, torch.int32),
                stage_thr=dev([s.threshold for s in st], torch.float32),
            )
        return self._tables[key]


# ---------------------------------------------------------------------------
# canvas resize
# ---------------------------------------------------------------------------


def resize_tables(plan: PyramidPlan, device) -> list:
    """Per level: (block_top, block_left, h_s, w_s, y0, y1, cy, x0, x1,
    cx) with the INTER_LINEAR_EXACT source indices and 8-bit coefficients
    on device."""
    levels = []
    for s in range(len(plan.scales)):
        h_s, w_s = int(plan.scaled_h[s]), int(plan.scaled_w[s])
        ys, cys = _axis_tab(plan.img_h, h_s)
        xs, cxs = _axis_tab(plan.img_w, w_s)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        levels.append((
            int(plan.block_top[s]), int(plan.block_left[s]), h_s, w_s,
            dev(ys), dev(np.minimum(ys + 1, plan.img_h - 1)), dev(cys).to(torch.int32),
            dev(xs), dev(np.minimum(xs + 1, plan.img_w - 1)), dev(cxs).to(torch.int32),
        ))
    return levels


def build_pixel_canvas(img, plan: PyramidPlan, levels) -> torch.Tensor:
    """u8 frame (H, W) → (canvas_h, canvas_w) int32 pixel canvas: each
    level resized exactly, at (block_top + 1, block_left + 1); the block's
    top row and first column stay zero.

    In int32: H = (256−cy)·p[y0] + cy·p[y1] (≤ 65280), then
    v = (256−cx)·H[x0] + cx·H[x1] (< 2^24), pixel = min((v + 2^15) >> 16, 255)."""
    p = img.to(torch.int32)
    px = torch.zeros((plan.canvas_h, plan.canvas_w), dtype=torch.int32, device=img.device)
    for (top, left, h_s, w_s, y0, y1, cy, x0, x1, cx) in levels:
        rows = (256 - cy)[:, None] * p[y0] + cy[:, None] * p[y1]
        v = (256 - cx) * rows[:, x0] + cx * rows[:, x1]
        px[top + 1 : top + 1 + h_s, left + 1 : left + 1 + w_s] = torch.clamp_max((v + (1 << 15)) >> 16, 255)
    return px


def positions_to_rects(plan: PyramidPlan, sel: np.ndarray) -> np.ndarray:
    """Flat dense-grid indices (r·out_w + c) → unclipped image-space rects.

    The OpenCV invoker maps window coords with FLOAT32 arithmetic:
    cvRound(x·scalingFactor) with a float scalingFactor (50·1.21f is
    exactly 60.5f and rounds to even 60). Candidates at the coarsest level
    may overhang the image; clipping happens after grouping. A
    shelf-packed plan is decoded through its level map and each level's
    (block_top, block_left)."""
    sel = np.asarray(sel, np.int64)
    if sel.size == 0:
        return np.zeros((0, 4), np.int32)
    r = sel // plan.out_w
    c = sel % plan.out_w
    s = plan.lvl2d[r, c].astype(np.int32) if plan.packed else plan.row_scale[r]
    if (s < 0).any():
        raise ValueError("a window position lies outside every pyramid level")
    y = r - plan.block_top[s]
    c = c - plan.block_left[s]
    f = plan.scales[s].astype(np.float32)
    x_img = np.rint(c.astype(np.float32) * f).astype(np.int32)
    y_img = np.rint(y.astype(np.float32) * f).astype(np.int32)
    return np.stack([x_img, y_img, plan.box_w[s], plan.box_h[s]], axis=1)


class TorchDetector:
    """detectMultiScale-compatible detector running each frame through
    ``detect/engine.py`` on one device.

    device: where the work runs ("cuda", "cuda:0", "cpu"); "cuda" with no
    card present raises — nothing falls back to the CPU. impl="ref" runs
    the plain PyTorch twin of every kernel (on any device).

    engine, as the JAX package names them: "fused" (``Engine``, upright
    stump Haar), "pallas" (``StageEngine``, any stump Haar cascade), or
    "auto" ("fused" for an upright cascade, "pallas" for a tilted one).
    front_trees applies to "fused" only.

    pack_band: the shelf-packed pyramid plan (``build_plan(pack_band=
    True)``); None takes it for "fused" and the plain stack for "pallas",
    whose tilted canvas resets per block top and cannot hold levels side
    by side. packed_front ("fused" only): run the front over the list of
    live 16x512 blocks (``detect/packed_front.py``) instead of the whole
    canvas. The JAX package's CCTPU_PACK_BAND and CCTPU_PACKED_FRONT."""

    def __init__(self, model: CascadeModel, exact: bool = False, device="cuda",
                 engine: str = "auto", front_trees: int = 250, impl: str = "auto",
                 pack_band: bool | None = None, packed_front: bool = False):
        from cascadeclassifier_tpu_torch.detect.engine import Engine, StageEngine

        if engine not in ("auto", "fused", "pallas"):
            raise ValueError(f"engine must be 'auto', 'fused' or 'pallas', got {engine!r}")
        if exact:
            raise NotImplementedError(
                "exact (f64 stage sum) mode is not ported yet; use exact=False"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        # the slice needs no matmul; keep any that creeps in at full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.exact = exact
        self.packed = PackedCascade.from_model(model)
        if engine == "auto":
            engine = "pallas" if self.packed.has_tilted else "fused"
        self.engine_name = engine
        self.pack_band = engine == "fused" if pack_band is None else bool(pack_band)
        if engine == "pallas" and self.pack_band:
            raise ValueError("engine 'pallas' takes the plain stack only (pack_band=False)")
        if engine == "pallas" and packed_front:
            raise ValueError("packed_front applies to engine 'fused' only")
        if engine == "fused":
            self.engine = Engine(self.packed, self.device, front_trees=front_trees, impl=impl,
                                 packed_front=packed_front)
        else:
            self.engine = StageEngine(self.packed, self.device, impl=impl)

    def plan_for(self, w, h, scale_factor, min_size, max_size):
        return build_plan(
            w, h, self.packed.win_w, self.packed.win_h, scale_factor,
            tuple(min_size) if min_size else None,
            tuple(max_size) if max_size else None,
            pack_band=self.pack_band,
        )

    def raw_windows(self, img: np.ndarray, scale_factor: float = 1.1,
                    min_size=None, max_size=None, timings: dict | None = None):
        """(plan, flat canvas indices of every window that passes the
        cascade, ascending). timings: see Engine.detect."""
        img = np.ascontiguousarray(img)
        if img.ndim != 2 or img.dtype != np.uint8:
            raise ValueError("expected a 2-D uint8 frame")
        h, w = img.shape
        plan = self.plan_for(w, h, scale_factor, min_size, max_size)
        frame = torch.from_numpy(img).to(self.device)
        return plan, self.engine.detect(frame, plan, timings)

    @staticmethod
    def group(plan, idx, min_neighbors: int) -> np.ndarray:
        """Raw window indices → grouped, clipped (N, 4) int32 rects."""
        rects = positions_to_rects(plan, idx)
        return clip_rects(
            group_rectangles(rects, min_neighbors), plan.img_w, plan.img_h
        )

    def detect_multi_scale(self, img: np.ndarray, scale_factor: float = 1.1,
                           min_neighbors: int = 3, min_size=None,
                           max_size=None) -> np.ndarray:
        """Returns (N, 4) int32 rects (x, y, w, h) in image coords."""
        plan, idx = self.raw_windows(img, scale_factor, min_size, max_size)
        return self.group(plan, idx, min_neighbors)

    def detect_multi_scale_batch(self, frames, scale_factor: float = 1.1,
                                 min_neighbors: int = 3, min_size=None,
                                 max_size=None) -> list:
        """detect_multi_scale over a sequence of frames, one at a time."""
        return [
            self.detect_multi_scale(f, scale_factor, min_neighbors, min_size, max_size)
            for f in frames
        ]
