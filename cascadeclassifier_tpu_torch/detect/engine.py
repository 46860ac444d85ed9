"""The detection pipeline for one frame on one device.

Counterpart of ``cascadeclassifier_tpu/detect/engine.py::FusedEngine`` in
its static-front configuration (``FusedEngine._build``), without the TPU
layout machinery (parity planes, plane split, stitch, tile geometries,
block nonzero, limb matmuls):

  resize   exact resize of every level into one pixel canvas (torch)
  integral sum and sum² integrals, int32 mod 2^32       (kernel 1)
  prep     variance gate + stage 0 + closed-form OpenCV walk (torch)
  front    stages 1 … n_dense−1 at every alive window  (kernel 2)
  extract  ascending survivor indices (one host sync)   (torch)
  patchify the survivors' integral patches              (kernel 3)
  tail     stages n_dense … on the patches              (torch)

n_dense is the first stage at which the trees summed from stage 1 reach
``front_trees`` (250 by default, as in the JAX package).
"""

from __future__ import annotations

import time

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect.compact import TailTables, extract_survivors, tail
from cascadeclassifier_tpu_torch.detect.dense import (
    dense_variance_gate,
    parity_visited,
    stage_pass,
    static_visit_grid,
)
from cascadeclassifier_tpu_torch.detect.detector import build_pixel_canvas, resize_tables
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import integral
from cascadeclassifier_tpu_torch.detect.patchify import patchify


def front_cutover(cascade, front_trees: int) -> int:
    """First stage index served by the tail (len(stages) if none)."""
    n_stages = len(cascade.stages)
    budget = 0
    for si in range(1, n_stages):
        budget += cascade.stages[si].ntrees
        if budget >= front_trees:
            return si + 1
    return n_stages


class Engine:
    """Runs the pipeline above. ``impl="ref"`` sends every kernel op to
    its plain PyTorch twin (on any device); ``"auto"`` dispatches on the
    tensor's device."""

    def __init__(self, cascade, device, front_trees: int = 250, impl: str = "auto"):
        _build.check_impl(impl)
        self.cascade = cascade
        self.device = torch.device(device)
        self.impl = impl
        self.n_dense = front_cutover(cascade, front_trees)
        self.tail_tables = TailTables(
            cascade, range(self.n_dense, len(cascade.stages)), self.device
        )
        self.last_counts = {}
        self._plans = {}

    def _plan_tensors(self, plan):
        key = (plan.img_w, plan.img_h, plan.canvas_h, plan.canvas_w,
               tuple(plan.scaled_w))
        if key not in self._plans:
            grid = torch.as_tensor(static_visit_grid(plan), device=self.device)
            ordinal = torch.cumsum(grid.to(torch.int32), dim=1, dtype=torch.int32)
            self._plans[key] = (resize_tables(plan, self.device), grid, ordinal)
        return self._plans[key]

    def prep(self, sum2d, sq2d, plan):
        """Gate + stage 0 + the serial-walk visited mask → (inv_nf, alive)."""
        _, grid, ordinal = self._plan_tensors(plan)
        c = self.cascade
        out_h, out_w = plan.out_h, plan.out_w
        gate, inv_nf = dense_variance_gate(sum2d, sq2d, c.win_w, c.win_h, out_h, out_w)
        passed0 = stage_pass(sum2d, c.stages[0], out_h, out_w, inv_nf)
        visited = parity_visited(gate & ~passed0, grid, ordinal)
        return inv_nf, gate & grid & passed0 & visited

    def detect(self, img, plan, timings: dict | None = None):
        """u8 frame (H, W) on device → ascending flat indices (numpy int64,
        r·out_w + c) of the windows that pass every stage.

        timings: optional dict; when given, the device is synchronized
        after each phase and the phase's wall milliseconds are added under
        its name (resize, integral, prep, front, extract, patchify, tail)."""
        c = self.cascade
        mark = _PhaseClock(self.device, timings)
        levels, _, _ = self._plan_tensors(plan)
        px = build_pixel_canvas(img, plan, levels)
        mark("resize")
        sum2d, sq2d = integral(px, impl=self.impl)
        mark("integral")
        inv_nf, alive = self.prep(sum2d, sq2d, plan)
        mark("prep")
        alive = front(sum2d, inv_nf, alive, c, 1, self.n_dense, impl=self.impl)
        mark("front")
        idx = extract_survivors(alive)
        n = int(idx.numel())
        mark("extract")
        self.last_counts = {"front_survivors": n}
        if self.n_dense < len(c.stages) and n > 0:
            r = (idx // plan.out_w).to(torch.int32)
            col = (idx % plan.out_w).to(torch.int32)
            ps = patchify(sum2d, r, col, n, c.win_w, c.win_h, impl=self.impl)
            mark("patchify")
            idx = idx[tail(ps, inv_nf.reshape(-1)[idx], self.tail_tables)]
            mark("tail")
        return idx.cpu().numpy()


class _PhaseClock:
    """Adds each phase's wall time (ms, device synchronized) to a dict;
    does nothing when the dict is None."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.t = time.perf_counter()

    def __call__(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now
