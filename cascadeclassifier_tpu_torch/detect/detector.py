"""Multi-scale cascade detector on PyTorch (CUDA or CPU).

Counterpart of ``cascadeclassifier_tpu/detect/detector.py``: the packed
cascade, the exact INTER_LINEAR_EXACT canvas resize, the mapping of
window positions to image rects, and ``TorchDetector``, whose
``detect_multi_scale`` matches cv::CascadeClassifier::detectMultiScale
for Haar cascades (stumps or node trees, upright or tilted features) and
LBP cascades, with f64 stage sums (``exact=True``, the default, as the
runtime and the JAX package) or f32 ones. ``make_detector`` sends a HOG
cascade to ``detect/hog_detector.py::HOGDetector`` instead, as the JAX
package's detect CLI routes it.

Runtime semantics replicated:
  - variance gate: reject window unless nf² > 0 and area/nf < 0.1
  - Haar value = f32(Σ wᵢ·rectsumᵢ) · f32(1/√nf²); split: value < threshold
  - stage pass: Σ leaves ≥ f32(stageThreshold) − 1e-5
  - LBP: no gate; categorical split via subset bitmask (bit set → left)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cascadeclassifier_tpu_torch.detect.grouping import clip_rects, group_rectangles
from cascadeclassifier_tpu_torch.detect.pyramid import PyramidPlan, build_plan
from cascadeclassifier_tpu_torch.detect.records import KINDS, node_tables, tile_pitch, tree_records
from cascadeclassifier_tpu_torch.models.model import (
    FEATURE_HAAR,
    FEATURE_HOG,
    FEATURE_LBP,
    CascadeModel,
)
from cascadeclassifier_tpu_torch.ops.resize import _axis_tab
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count, span

THRESHOLD_EPS = np.float32(1e-5)


@dataclasses.dataclass
class PackedStage:
    threshold: np.float32  # effective (xml − 1e-5)
    ntrees: int
    # the stump arrays; when deep_trees is set they hold node 0 only and
    # deep_trees drives evaluation
    feat_rects: np.ndarray  # (T, 3, 4) int32 rect geometry (x, y, w, h) (Haar)
    weights: np.ndarray  # (T, 3) float32, 0 for absent rects (Haar)
    tilted: np.ndarray  # (T,) bool — the tree's feature is a 45° one (Haar)
    thr: np.ndarray  # (T,) float32 (Haar)
    left_leaf: np.ndarray  # (T,) float32
    right_leaf: np.ndarray  # (T,) float32
    subsets: np.ndarray | None = None  # (T, 8) int32 categorical split (LBP)
    lbp_rects: np.ndarray | None = None  # (T, 4) int32 cell rect (LBP)
    # any tree with >1 internal node: [(WeakTree, [feature per node])]
    deep_trees: list | None = None


@dataclasses.dataclass
class PackedCascade:
    """Haar (stumps or node trees, upright and tilted features) or LBP
    cascade as flat arrays."""

    win_w: int
    win_h: int
    stages: list
    feature_type: int = FEATURE_HAAR
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def is_lbp(self) -> bool:
        return self.feature_type == FEATURE_LBP

    @property
    def kind(self) -> str:
        """The kernels' record form (``detect/records.py``): "lbp", "node"
        (a Haar cascade with any tree of more than one internal node) or
        "stump"."""
        if self.is_lbp:
            return "lbp"
        return "node" if any(st.deep_trees is not None for st in self.stages) else "stump"

    @property
    def has_tilted(self) -> bool:
        if self.is_lbp:
            return False
        return any(
            st.tilted.any() if st.deep_trees is None
            else any(f.tilted for _, feats in st.deep_trees for f in feats)
            for st in self.stages
        )

    @classmethod
    def from_model(cls, m: CascadeModel) -> "PackedCascade":
        if m.feature_type not in (FEATURE_HAAR, FEATURE_LBP):
            raise ValueError(
                "a HOG cascade has no packed form: detect/hog_detector.py::HOGDetector "
                "serves it (make_detector routes it there)"
            )
        stages = []
        for s in m.stages:
            t = len(s.trees)
            fr = np.zeros((t, 3, 4), np.int32)
            w = np.zeros((t, 3), np.float32)
            tl = np.zeros(t, bool)
            thr = np.zeros(t, np.float32)
            subs = np.zeros((t, 8), np.int32)
            ll = np.zeros(t, np.float32)
            rl = np.zeros(t, np.float32)
            lbp = np.zeros((t, 4), np.int32)
            for i, tree in enumerate(s.trees):
                f = m.features[int(tree.feature_idx[0])]
                if tree.left[0] <= 0:
                    ll[i] = tree.leaf_values[-int(tree.left[0])]
                if tree.right[0] <= 0:
                    rl[i] = tree.leaf_values[-int(tree.right[0])]
                if m.feature_type == FEATURE_HAAR:
                    for ri, (x, y, rw, rh, wt) in enumerate(f.rects):
                        fr[i, ri] = (x, y, rw, rh)
                        w[i, ri] = wt
                    tl[i] = f.tilted
                    thr[i] = tree.threshold[0]
                else:
                    lbp[i] = f.rect
                    subs[i] = tree.subsets[0]
            deep = None
            if any(tr.num_nodes > 1 for tr in s.trees):
                deep = [(tr, [m.features[int(v)] for v in tr.feature_idx]) for tr in s.trees]
            stages.append(PackedStage(
                threshold=np.float32(s.threshold) - THRESHOLD_EPS,
                ntrees=t, feat_rects=fr, weights=w, tilted=tl, thr=thr,
                left_leaf=ll, right_leaf=rl, subsets=subs, lbp_rects=lbp, deep_trees=deep,
            ))
        return cls(win_w=m.width, win_h=m.height, stages=stages, feature_type=m.feature_type)

    def __post_init__(self):
        """Every corner a kernel reads lies inside the window, so no read
        leaves the canvas: Haar upright (x, y)..(x+w, y+h); tilted (x, y),
        (x−h, y+h), (x+w, y+w), (x+w−h, y+w+h) (dense.py's assert); LBP
        (x + i·w, y + j·h) for i, j in 0..3; for node trees, every node's."""
        def inside(rects, tilted):
            x, y, w, h = np.moveaxis(np.asarray(rects, np.int64).reshape(-1, 4), -1, 0)
            upright = (x >= 0) & (y >= 0) & (x + w <= self.win_w) & (y + h <= self.win_h)
            tilt = (x - h >= 0) & (y >= 0) & (x + w <= self.win_w) & (y + w + h <= self.win_h)
            return np.where(tilted, tilt, upright).all()

        for si, st in enumerate(self.stages):
            if self.is_lbp:
                cells = np.asarray(st.lbp_rects, np.int64) * [1, 1, 3, 3]
                ok = inside(cells, False)
                for _, feats in st.deep_trees or ():
                    ok = ok and all(inside(np.multiply(f.rect, [1, 1, 3, 3]), False)
                                    for f in feats)
            else:
                ok = inside(st.feat_rects, np.repeat(st.tilted, 3))
                for _, feats in st.deep_trees or ():
                    ok = ok and all(inside([r[:4] for r in f.rects], bool(f.tilted))
                                    for f in feats)
            if not ok:
                raise ValueError(f"stage {si}: a rect leaves the {self.win_w}x{self.win_h} window")

    def device_table(self, device) -> dict:
        """Every tree's parameters on the device, built once per device:
        the records (``detect/records.py``) that the front, packed front and
        stage kernels read, with the shared-memory pitch they are resolved
        against, the kind, and for node records each tree's root and the
        leaf table (None for stumps)."""
        key = str(torch.device(device))
        if key not in self._tables:
            st = self.stages
            start = np.concatenate([[0], np.cumsum([s.ntrees for s in st])])

            def dev(a, dt):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

            roots = leaves = None
            if self.kind == "stump":
                rec = tree_records(st, self.win_w, self.win_h)
            else:
                rec, roots, leaves = node_tables(st, self.win_w, self.win_h, self.is_lbp,
                                                 self.has_tilted)
                roots, leaves = dev(roots, torch.int32), dev(leaves, torch.float32)
            self._tables[key] = dict(
                records=dev(rec.view(np.uint8).reshape(len(rec), -1), torch.uint8),
                pitch=tile_pitch(self.win_w),
                kind=KINDS[self.kind],
                has_tilted=self.has_tilted,
                tree_root=roots,
                leaves=leaves,
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


def build_pixel_canvas(img, plan: PyramidPlan, levels, dtype=torch.int32) -> torch.Tensor:
    """u8 frame (H, W) → (canvas_h, canvas_w) pixel canvas of dtype (int32,
    or uint8, which holds every value): each level resized exactly, at
    (block_top + 1, block_left + 1); the block's top row and first column
    stay zero.

    In int32: H = (256−cy)·p[y0] + cy·p[y1] (≤ 65280), then
    v = (256−cx)·H[x0] + cx·H[x1] (< 2^24), pixel = min((v + 2^15) >> 16, 255)."""
    p = img.to(torch.int32)
    px = torch.zeros((plan.canvas_h, plan.canvas_w), dtype=dtype, device=img.device)
    for (top, left, h_s, w_s, y0, y1, cy, x0, x1, cx) in levels:
        rows = (256 - cy)[:, None] * p[y0] + cy[:, None] * p[y1]
        v = (256 - cx) * rows[:, x0] + cx * rows[:, x1]
        px[top + 1 : top + 1 + h_s, left + 1 : left + 1 + w_s] = torch.clamp_max((v + (1 << 15)) >> 16, 255)
    return px


def _level_row_col(plan: PyramidPlan, sel: np.ndarray):
    """Flat canvas indices → (level, row in the level, column) arrays."""
    r = sel // plan.out_w
    c = sel % plan.out_w
    s = plan.lvl2d[r, c].astype(np.int32) if plan.packed else plan.row_scale[r]
    if (s < 0).any():
        raise ValueError("a window position lies outside every pyramid level")
    return s, r - plan.block_top[s], c - plan.block_left[s]


def _image_rects(plan: PyramidPlan, s, y, c) -> np.ndarray:
    f = plan.scales[s].astype(np.float32)
    x_img = np.rint(c.astype(np.float32) * f).astype(np.int32)
    y_img = np.rint(y.astype(np.float32) * f).astype(np.int32)
    return np.stack([x_img, y_img, plan.box_w[s], plan.box_h[s]], axis=1)


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
    return _image_rects(plan, *_level_row_col(plan, sel))


def _stack_rects(plan: PyramidPlan, sel: np.ndarray) -> np.ndarray:
    """positions_to_rects in the plain stack's order: level, then row in
    the level, then column. On the plain stack (levels stacked downwards,
    each at column 0) that is ascending index order; a shelf-packed plan
    lays levels side by side and differs."""
    sel = np.asarray(sel, np.int64)
    if sel.size == 0:
        return np.zeros((0, 4), np.int32)
    s, y, c = _level_row_col(plan, sel)
    o = np.lexsort((c, y, s))
    return _image_rects(plan, s[o], y[o], c[o])


class TorchDetector:
    """detectMultiScale-compatible detector running each frame through
    ``detect/engine.py`` on one device.

    exact: f64 stage sums, bit for bit OpenCV's runtime (True, the default,
    as the JAX package's TPUDetector); False takes f32 sums (the same
    detections except at windows within ~1e-6 of a stage threshold).

    device: where the work runs ("cuda", "cuda:0", "cpu"); "cuda" with no
    card present raises — nothing falls back to the CPU. impl="ref" runs
    the plain PyTorch twin of every kernel (on any device).

    engine, as the JAX package names them: "fused" (``Engine``, upright
    cascades: stump Haar with a front and a tail, node trees and LBP with
    every stage in the front), "pallas" (``StageEngine``, every cascade
    the port takes: stump or node-tree Haar, upright or tilted, and LBP),
    or "auto" ("fused" for an upright stump Haar cascade, "pallas" for a
    tilted, node-tree or LBP one, whose every stage the stage kernel
    runs). front_trees applies to "fused" only. A HOG cascade raises:
    ``HOGDetector`` serves it (``make_detector`` picks the class).

    pack_band: the shelf-packed pyramid plan (``build_plan(pack_band=
    True)``); None takes it for "fused" and the plain stack for "pallas",
    whose tilted canvas resets per block top and cannot hold levels side
    by side. packed_front ("fused", stump Haar only): run the front over
    the list of live 16x512 blocks (``detect/packed_front.py``) instead of
    the whole canvas. The JAX package's CCTPU_PACK_BAND and
    CCTPU_PACKED_FRONT."""

    def __init__(self, model: CascadeModel, exact: bool = True, device="cuda",
                 engine: str = "auto", front_trees: int = 250, impl: str = "auto",
                 pack_band: bool | None = None, packed_front: bool = False):
        from cascadeclassifier_tpu_torch.detect.engine import Engine, StageEngine

        if model.feature_type == FEATURE_HOG:
            raise ValueError("TorchDetector runs Haar and LBP cascades; a HOG cascade goes to "
                             "detect/hog_detector.py::HOGDetector (see make_detector)")
        if engine not in ("auto", "fused", "pallas"):
            raise ValueError(f"engine must be 'auto', 'fused' or 'pallas', got {engine!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        # the slice needs no matmul; keep any that creeps in at full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.exact = bool(exact)
        # what a replica on another device is built with (devices= below)
        self._options = dict(exact=exact, engine=engine, front_trees=front_trees, impl=impl,
                             pack_band=pack_band, packed_front=packed_front)
        self._replicas = {}
        self.packed = PackedCascade.from_model(model)
        if engine == "auto":
            upright_stumps = self.packed.kind == "stump" and not self.packed.has_tilted
            engine = "fused" if upright_stumps else "pallas"
        self.engine_name = engine
        self.pack_band = engine == "fused" if pack_band is None else bool(pack_band)
        if engine == "pallas" and self.pack_band:
            raise ValueError("engine 'pallas' takes the plain stack only (pack_band=False)")
        if engine == "pallas" and packed_front:
            raise ValueError("packed_front applies to engine 'fused' only")
        if engine == "fused":
            self.engine = Engine(self.packed, self.device, front_trees=front_trees, impl=impl,
                                 packed_front=packed_front, exact=self.exact)
        else:
            self.engine = StageEngine(self.packed, self.device, impl=impl, exact=self.exact)

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
        with span("detect.raw_windows"):
            h, w = img.shape
            plan = self.plan_for(w, h, scale_factor, min_size, max_size)
            with span("detect.upload"):
                count(SYNC)
                frame = torch.from_numpy(img).to(self.device)
            return plan, self.engine.detect(frame, plan, timings)

    @staticmethod
    def group(plan, idx, min_neighbors: int) -> np.ndarray:
        """Raw window indices → grouped, clipped (N, 4) int32 rects.
        Grouping numbers its classes in the order its rects arrive, so
        they arrive in the plain stack's order whatever the plan's layout,
        as the JAX package's detector hands them over: the same rects in
        the same order from either plan."""
        with span("detect.group"):
            return clip_rects(
                group_rectangles(_stack_rects(plan, idx), min_neighbors), plan.img_w, plan.img_h
            )

    def detect_multi_scale(self, img: np.ndarray, scale_factor: float = 1.1,
                           min_neighbors: int = 3, min_size=None,
                           max_size=None, max_det: int = 1 << 16) -> np.ndarray:
        """Returns (N, 4) int32 rects (x, y, w, h) in image coords. More
        than max_det raw windows (before grouping) raise RuntimeError, as
        the JAX package's detector does."""
        with span("detect.frame"):
            plan, idx = self.raw_windows(img, scale_factor, min_size, max_size)
            if len(idx) > max_det:
                raise RuntimeError(
                    f"{len(idx)} raw detections exceed max_det={max_det}; "
                    "pass a larger max_det"
                )
            return self.group(plan, idx, min_neighbors)

    def replica(self, device) -> "TorchDetector":
        """This detector on device: itself, or a copy built once with the
        same cascade and options, holding its own cascade tables there."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self._replicas:
            self._replicas[device] = TorchDetector(self.model, device=device, **self._options)
        return self._replicas[device]

    def detect_multi_scale_batch(self, frames, scale_factor: float = 1.1,
                                 min_neighbors: int = 3, min_size=None,
                                 max_size=None, max_det: int = 1 << 14, devices=None) -> list:
        """detect_multi_scale over a sequence of frames, one at a time;
        max_det is raised to at least 1 << 16, as the JAX package's
        frame-at-a-time batch path raises it. devices: an optional list of
        torch devices; frame i goes to devices[i % len(devices)], each
        device with its own copy of the cascade tables (data-parallel
        detection, the same per-frame results)."""
        devices = [self.device] if not devices else list(devices)
        return [
            self.replica(devices[i % len(devices)]).detect_multi_scale(
                f, scale_factor, min_neighbors, min_size, max_size,
                max_det=max(max_det, 1 << 16))
            for i, f in enumerate(frames)
        ]


def make_detector(model: CascadeModel, **options):
    """The detector for ``model``, as the JAX package's detect CLI picks
    it: ``HOGDetector`` for a HOG cascade (options ``device``, ``batch``,
    ``impl``; an engine option raises TypeError, it does not apply), else
    ``TorchDetector`` with the options."""
    if model.feature_type == FEATURE_HOG:
        from cascadeclassifier_tpu_torch.detect.hog_detector import HOGDetector

        return HOGDetector(model, **options)
    return TorchDetector(model, **options)
