"""The detection pipelines for one frame on one device.

``Engine`` (``engine="fused"``) is the counterpart of
``cascadeclassifier_tpu/detect/engine.py::FusedEngine`` in its
static-front configuration (``FusedEngine._build``), without the TPU
layout machinery (parity planes, plane split, stitch, tile geometries,
block nonzero, limb matmuls):

  resize   exact resize of every level into one pixel canvas (torch)
  integral sum and sum² integrals, int32 mod 2^32       (kernel 1)
  prep     variance gate + stage 0 + OpenCV walk        (kernel prep)
  front    stages 1 … n_dense−1 at every alive window  (kernel 2)
  extract  ascending survivor indices (one host sync)   (torch)
  patchify the survivors' integral patches              (kernel 3)
  tail     stages n_dense … on the patches              (torch)

With ``packed_front=True`` (the JAX package's CCTPU_PACKED_FRONT=1) the
front phase becomes

  blocks        the list of live 16x512 mask blocks, on the device (torch)
  packed_front  stages 1 … n_dense−1 over the listed blocks (kernel
                packed_front)

n_dense is the first stage at which the trees summed from stage 1 reach
``front_trees`` (250 by default, as in the JAX package). It takes
upright cascades, on the plain or the shelf-packed plan; on the latter
the walk restarts at the gaps between levels that share a canvas row.
A node-tree or LBP cascade runs every stage in the front (n_dense = the
stage count, no patchify and no tail), as the JAX fused engine runs
every stage of a deep cascade densely; LBP has no variance gate and no
inv_nf. ``exact=True`` takes stage 0, the front and the tail in f64.

``StageEngine`` (``engine="pallas"``) is the counterpart of
``TPUDetector``'s ``pallas`` branch (``_submit_one`` with
``_make_collect_fn``), and of its ``xla`` branch for what the Pallas
kernel does not take (f64 sums, node trees, LBP); it takes every cascade
the port does, tilted or not:

  resize   as above                                      (torch)
  integral as above                                      (kernel 1)
  tilted   the tilted canvas, for a tilted cascade       (kernel tilted)
  gate     the variance gate (Haar; LBP has none)        (torch)
  stage    every stage at every alive window, with
           stage 0's pass mask                           (kernel stage)
  walk     closed-form OpenCV walk from gate ∧ ¬passed0  (torch)
  extract  ascending indices of alive ∧ visited (one host sync)
"""

from __future__ import annotations

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect.compact import TailTables, extract_survivors, tail
from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate, parity_visited
from cascadeclassifier_tpu_torch.detect.detector import build_pixel_canvas, resize_tables
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import integral
from cascadeclassifier_tpu_torch.detect.packed_front import live_block_list, packed_front
from cascadeclassifier_tpu_torch.detect.patchify import patchify
from cascadeclassifier_tpu_torch.detect.prep import prep, walk_code, walk_inputs
from cascadeclassifier_tpu_torch.detect.stage import stage
from cascadeclassifier_tpu_torch.detect.tilted import tilted
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count, span


def front_cutover(cascade, front_trees: int) -> int:
    """First stage index served by the tail (len(stages) if none)."""
    n_stages = len(cascade.stages)
    budget = 0
    for si in range(1, n_stages):
        budget += cascade.stages[si].ntrees
        if budget >= front_trees:
            return si + 1
    return n_stages


class _Pipeline:
    """What both engines share: the cascade, the device, the kernel
    dispatch (``impl="ref"`` sends every kernel op to its plain PyTorch
    twin, on any device; ``"auto"`` dispatches on the tensor's device)
    and the per-plan device tables."""

    def __init__(self, cascade, device, impl: str = "auto", exact: bool = False):
        _build.check_impl(impl)
        self.cascade = cascade
        self.device = torch.device(device)
        self.impl = impl
        self.exact = exact
        self.last_counts = {}
        self._plans = {}

    @staticmethod
    def _plan_key(plan):
        return (plan.img_w, plan.img_h, plan.canvas_h, plan.canvas_w,
                tuple(plan.scaled_w), plan.packed)

    def _plan_tensors(self, plan):
        """(resize tables, the walk's code plane: ``prep.walk_code``)."""
        key = self._plan_key(plan)
        if key not in self._plans:
            code = torch.as_tensor(walk_code(plan), device=self.device)
            self._plans[key] = (resize_tables(plan, self.device), code)
        return self._plans[key]

    def _walk_tensors(self, plan):
        """(resize tables, visit grid, its ordinal) from the code plane, for
        the torch walk (``dense.parity_visited``); built once a plan."""
        key = ("walk", *self._plan_key(plan))
        if key not in self._plans:
            levels, code = self._plan_tensors(plan)
            self._plans[key] = (levels, *walk_inputs(code)[:2])
        return self._plans[key]


class Engine(_Pipeline):
    """Runs the static-front pipeline above (upright cascades only)."""

    def __init__(self, cascade, device, front_trees: int = 250, impl: str = "auto",
                 packed_front: bool = False, exact: bool = False):
        if cascade.has_tilted:
            raise ValueError("the fused engine takes upright cascades; use StageEngine")
        if packed_front and cascade.kind != "stump":
            raise ValueError("packed_front takes stump Haar cascades")
        super().__init__(cascade, device, impl, exact)
        self.packed_front = packed_front
        self.n_dense = (front_cutover(cascade, front_trees) if cascade.kind == "stump"
                        else len(cascade.stages))
        self.tail_tables = TailTables(
            cascade, range(self.n_dense, len(cascade.stages)), self.device
        )

    def prep(self, sum2d, sq2d, plan):
        """Gate + stage 0 + the serial-walk visited mask → (inv_nf, alive);
        inv_nf is None for LBP, which has no gate."""
        code = self._plan_tensors(plan)[1]
        return prep(sum2d, sq2d, code, self.cascade, impl=self.impl, exact=self.exact)

    def detect(self, img, plan, timings: dict | None = None):
        """u8 frame (H, W) on device → ascending flat indices (numpy int64,
        r·out_w + c) of the windows that pass every stage.

        Each phase is a span ``engine.<phase>`` (resize, integral, prep,
        front or blocks and packed_front, extract, patchify, tail; the
        fetch of the indices is ``engine.fetch``). timings: optional dict;
        when given, the device is synchronized after each phase and the
        phase's wall milliseconds are added under its name."""
        c = self.cascade
        with span("engine.resize", timings):
            levels = self._plan_tensors(plan)[0]
            px = build_pixel_canvas(img, plan, levels, torch.uint8)  # read by integral alone
        with span("engine.integral", timings):
            sum2d, sq2d = integral(px, impl=self.impl)
        with span("engine.prep", timings):
            inv_nf, alive = self.prep(sum2d, sq2d, plan)
        if self.packed_front:
            with span("engine.blocks", timings):
                blk, nblk = live_block_list(alive)
            with span("engine.packed_front", timings):
                alive = packed_front(sum2d, inv_nf, alive, blk, nblk, c, 1, self.n_dense,
                                     impl=self.impl, exact=self.exact)
        else:
            with span("engine.front", timings):
                alive = front(sum2d, inv_nf, alive, c, 1, self.n_dense, impl=self.impl,
                              exact=self.exact)
        with span("engine.extract", timings):
            idx = extract_survivors(alive)
            n = int(idx.numel())
        self.last_counts = {"front_survivors": n}
        if self.n_dense < len(c.stages) and n > 0:
            with span("engine.patchify", timings):
                r = (idx // plan.out_w).to(torch.int32)
                col = (idx % plan.out_w).to(torch.int32)
                ps = patchify(sum2d, r, col, n, c.win_w, c.win_h, impl=self.impl)
            with span("engine.tail", timings):
                idx = idx[tail(ps, inv_nf.reshape(-1)[idx], self.tail_tables, self.exact)]
        return _fetch(idx)


class StageEngine(_Pipeline):
    """Runs the stage pipeline above (any cascade the port takes)."""

    def detect(self, img, plan, timings: dict | None = None):
        """As Engine.detect; phases: resize, integral, tilted, gate, stage,
        walk, extract."""
        c = self.cascade
        with span("engine.resize", timings):
            levels, grid, ordinal = self._walk_tensors(plan)
            px = build_pixel_canvas(img, plan, levels)  # int32: the tilted kernel reads it too
        with span("engine.integral", timings):
            sum2d, sq2d = integral(px, impl=self.impl)
        tilt2d = sum2d  # never read when no tree is tilted
        if c.has_tilted:
            # the JAX package's pad: a boundary error moves inward one
            # column per row, and no block has more than scaled_h + 2 rows
            with span("engine.tilted", timings):
                pad = int(plan.scaled_h.max()) + 1
                tilt2d = tilted(px, plan.is_top, pad, impl=self.impl)
        if c.is_lbp:  # no gate, and no inv_nf to read
            gate, inv_nf = None, None
        else:
            with span("engine.gate", timings):
                gate, inv_nf = dense_variance_gate(sum2d, sq2d, c.win_w, c.win_h, plan.out_h,
                                                   plan.out_w)
        # ANDing the static visit grid in only skips windows that the walk
        # masks out below; stage 0's pass mask is still taken everywhere
        with span("engine.stage", timings):
            alive, passed0 = stage(sum2d, tilt2d, inv_nf,
                                   grid if gate is None else gate & grid, c, 0, len(c.stages),
                                   impl=self.impl, exact=self.exact)
        with span("engine.walk", timings):
            visited = parity_visited(~passed0 if gate is None else gate & ~passed0, grid,
                                     ordinal)
        with span("engine.extract", timings):
            idx = extract_survivors(alive & visited)
            self.last_counts = {"raw_windows": int(idx.numel())}
        return _fetch(idx)


def _fetch(idx):
    """The survivors' indices to the host (numpy)."""
    with span("engine.fetch"):
        count(SYNC)
        return idx.cpu().numpy()
