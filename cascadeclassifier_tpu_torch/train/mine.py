"""The dense miner: a superbatch's accept masks in one pass (kernel 13).

Counterpart of ``cascadeclassifier_tpu/train/predictor.py:518
_dense_chunk_fn``, the JAX package's fused XLA program (no Pallas kernel)
for stump cascades with one value a feature (Haar upright and tilted,
LBP): the on-device level build, the window grid, the window integrals,
the norm factor, the corner product (Haar) or the 9 cell sums and 8
compares (LBP), and the f64 stump walk. For every window of every mining
level handed over, one byte: 1 where every stage accepts.

- ``pack_levels`` turns the trainer's levels ((img, positions, key), img a
  ``LazyLevel`` or an array, positions a ``GridRun`` or an (m, 2) array)
  into a level table on the device, one int64 row a run of consecutive
  windows of a level's grid (``LEVEL_COLS``: a ``GridRun`` gives its row
  in O(1), an array is checked and cut into runs), each row's first tile
  under each kind's tile shape (``tile_shape``), and two uint8 arenas: the
  lazy levels' sources (``SourceArena``, each uploaded once and found
  again by its ``src_id``) and the eager levels' images (uploaded per
  call).
- ``features_of`` takes the used features' records from the evaluator
  (Haar: 3 rects of 4 corner offsets, integer weights, a tilted flag;
  LBP: the 16 points of the corner grid).
- ``tree_table`` flattens the stages: each tree's feature row,
  threshold (LBP: subset words) and f32 leaves; each stage's end and
  threshold.
- ``mine`` launches ``csrc/mine.cu``'s tile kernel for a table on a CUDA
  device (one launch a call, counted in ``_build.LAUNCHES["mine"]``; a CTA
  a tile of a row's window grid, see the source) and
  ``mine_ref`` for one on the CPU, or with ``impl="ref"``: the plain
  version on the same arguments, built from ``build_level``,
  ``haar_rows`` / ``lbp_rows``, ``integral_tilted``, ``divide_nf`` and
  ``stump_walk``, a chunk of windows at a time. Before a launch ``mine``
  checks that the plain version's f32 corner product is exact for the
  features at this window (``check_exact``), as the kernel's integer sums
  agree with it only then; the plain version needs no such check and
  mines any window, as the JAX package does. ``mine_warp`` launches the
  design the tile kernel replaced (a warp a window), for timing beside it
  only (``utils/time_mine.py``). ``level_windows`` cuts
  the windows of a table (the plain version's, and the gather path's
  for deep-tree and HOG cascades).

The bits: the windows' pixels are INTER_LINEAR_EXACT's integers; the
integrals and the Haar rect sums exact integers, the corner product exact
while its partial sums stay within 2^24 (asserted); the division and the
norm factor's sqrt correctly rounded; the stage sums differences of one
f64 prefix over the tree axis in ``scan_cumsum``'s blocked order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.data.negreader import GridRun
from cascadeclassifier_tpu_torch.ops.integral import integral_tilted
from cascadeclassifier_tpu_torch.ops.resize import build_level
from cascadeclassifier_tpu_torch.train.evaluators import (
    LBPTrainEvaluator,
    corner_matrix,
    divide_nf,
    f32_matmul,
    haar_rows,
    lbp_rows,
)
from cascadeclassifier_tpu_torch.utils.profiling import SYNC, count

LEVEL_COLS = ("src_off", "eager", "sh", "sw", "dh", "dw", "oy", "ox", "nx", "w0", "count", "out",
              "tile_haar", "tile_haar_tilted", "tile_lbp")
SRC_OFF, EAGER, SH, SW, DH, DW, OY, OX, NX, W0, COUNT, OUT, TILE = range(len(LEVEL_COLS) - 2)
KIND_HAAR, KIND_HAAR_TILTED, KIND_LBP = 0, 1, 2  # csrc/mine.cu's kinds; column TILE + kind
KINDS = (KIND_HAAR, KIND_HAAR_TILTED, KIND_LBP)
# csrc/mine.cu's tile kernel: threads a CTA, the longest stage a thread a
# window walks (kStageMax), ints of a staged tree record and of a hand-off
# state, a CTA's shared memory at most
THREADS, STAGE_MAX, REC_INTS, HAND_INTS, MAX_SHARED = 256, 32, 32, 34, 232448
# a tile's shared memory at most: MIN_BLOCKS CTAs an SM (228 KB, 1 KB each
# reserved; mine.cu's kMinBlocks)
MIN_BLOCKS = 3
TILE_BUDGET = (233472 // MIN_BLOCKS) - 1024
# (tx, ty) tried in order: the first within TILE_BUDGET, else the last
# within MAX_SHARED
TILE_CANDIDATES = ((16, 8), (16, 4), (8, 8), (8, 4), (4, 4), (4, 2), (2, 2), (2, 1), (1, 1))
# a tile hands its survivors to a warp each once no more are alive than
# its warps (one survivor a warp), and before any stage of STAGE_MAX
# trees or more
HAND_LIVE = THREADS // 32
MAX_TREES = 16 ** 4  # the blocked scan's leaves and 3 carried levels (mine.cu: kLevels)
EXACT_LIMIT = 1 << 24  # f32 holds every integer up to here
CHUNK_WINDOWS = 65536  # windows a pass of the plain version or the gather path takes at most
ARENA_CAP_BYTES = 1 << 30  # the source arena starts over past this
# bytes kept free past the last source: the tile kernel reads a source
# row's byte after idx0 even where a 1-pixel-wide source weighs it 0
ARENA_PAD = 16
PIXEL_MAX = 255
# LBP: the 4 corner points (top left, top right, bottom left, bottom
# right) of each of the 9 cells, row-major, in the 4 x 4 grid
_CELL_POINTS = np.array([[r * 4 + c, r * 4 + c + 1, (r + 1) * 4 + c, (r + 1) * 4 + c + 1]
                         for r in range(3) for c in range(3)])


class SourceArena:
    """The lazy levels' sources in one uint8 buffer on the device, each
    uploaded once and found again by (src_id, shape). Past
    ``ARENA_CAP_BYTES`` the arena starts over with the sources of the call
    at hand."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.buf = torch.empty(0, dtype=torch.uint8, device=self.device)
        self.used = 0
        self.offsets = {}

    def place(self, srcs: dict) -> dict:
        """srcs {key: (h, w) uint8 array} → {key: offset}; each source not
        yet in the arena copied straight into its slice."""
        new = {k: v for k, v in srcs.items() if k not in self.offsets}
        need = sum(v.size for v in new.values())
        if self.used + need > ARENA_CAP_BYTES:
            self.offsets, self.used, new = {}, 0, dict(srcs)
            need = sum(v.size for v in new.values())
        if new:
            if self.used + need + ARENA_PAD > self.buf.numel():
                grown = torch.empty(max(2 * self.buf.numel(), self.used + need + ARENA_PAD),
                                    dtype=torch.uint8, device=self.device)
                grown[:self.used] = self.buf[:self.used]
                self.buf = grown
            count(SYNC, len(new))
            for k, v in new.items():
                self.buf[self.used:self.used + v.size].copy_(
                    torch.from_numpy(np.ascontiguousarray(v, np.uint8).reshape(-1)))
                self.offsets[k] = self.used
                self.used += v.size
        return {k: self.offsets[k] for k in srcs}


def tile_layout(ww: int, wh: int, kind: int, tx: int, ty: int) -> dict:
    """csrc/mine.cu's tile_layout: a tile's pixels across and down, the
    integrals' row pitch and its shared memory in ints."""
    pw, ph = (ww // 2) * (tx - 1) + ww, (wh // 2) * (ty - 1) + wh
    pitch = (pw + 1) | 1
    cells = (ph + 1) * pitch
    u = (2 if kind == KIND_HAAR_TILTED else 1) * cells
    u += u & 1
    build = u + (ph * pw + 3) // 4 + 3 * ph + 3 * pw + ph
    if kind != KIND_LBP:
        build += ty * pw  # the window rows' column sums of squares
    if kind == KIND_HAAR_TILTED:
        build += 3 * (pw + 2 * (ph + 1) + 1)
    walk = u + STAGE_MAX * REC_INTS + tx * ty * HAND_INTS
    return {"pw": pw, "ph": ph, "pitch": pitch, "ints": max(build, walk)}


@functools.lru_cache(maxsize=None)
def tile_shape(ww: int, wh: int, kind: int):
    """(tx, ty) windows a tile for this window and kind (TILE_CANDIDATES),
    or None where even one window's tile passes a CTA's shared memory."""
    for tx, ty in TILE_CANDIDATES:
        if tx * ty <= THREADS and 4 * tile_layout(ww, wh, kind, tx, ty)["ints"] <= TILE_BUDGET:
            return tx, ty
    one = TILE_CANDIDATES[-1]
    return one if 4 * tile_layout(ww, wh, kind, *one)["ints"] <= MAX_SHARED else None


def run_tiles(nx, w0, count, tx: int, ty: int):
    """Tiles of tx x ty windows over each run's grid rows (the first to
    the last it touches) and all nx columns (arrays over runs)."""
    rows = (w0 + count - 1) // nx - w0 // nx + 1
    return -(-nx // tx) * -(-rows // ty)


@dataclasses.dataclass
class Levels:
    """A superbatch's level table (R, 15) int64 (``LEVEL_COLS``), the two
    arenas, its window count, the windows of each level handed over and,
    by kind, the tile shape and the table's tiles (None where the window
    takes no tile)."""

    table: torch.Tensor
    lazy: torch.Tensor
    eager: torch.Tensor
    n: int
    counts: list
    shapes: tuple
    tiles: tuple


@dataclasses.dataclass
class Features:
    """Records of the used features, in the order of the trees' feature
    rows. Haar: offsets (K, 3, 4) int32 corner offsets into the window's
    flattened (wh+1) x (ww+1) integral (the tilted one for a tilted
    feature), weights (K, 3) int32 (0: no rect), tilted (K,) int32. LBP:
    points (K, 16) int32, the 4 x 4 corner grid row-major."""

    offsets: torch.Tensor | None = None
    weights: torch.Tensor | None = None
    tilted: torch.Tensor | None = None
    points: torch.Tensor | None = None
    has_tilted: bool = False
    bounds: dict = dataclasses.field(default_factory=dict)  # exact_bound by (ww, wh)

    @property
    def count(self) -> int:
        return int((self.points if self.points is not None else self.offsets).shape[0])

    @property
    def kind(self) -> int:
        if self.points is not None:
            return KIND_LBP
        return KIND_HAAR_TILTED if self.has_tilted else KIND_HAAR


@dataclasses.dataclass
class Trees:
    """Every tree a stump: feature (T,) int32 rows of the Features,
    thr (T,) f32 (0 for LBP), left and right (T,) f32 leaves, subsets
    (T, 8) int32 (LBP, else None); stage s ends before tree
    stage_end[s] (int32) and has threshold stage_thr[s] (f64)."""

    feature: torch.Tensor
    thr: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    subsets: torch.Tensor | None
    stage_end: torch.Tensor
    stage_thr: torch.Tensor
    n_features: int


def _array_rows(arrays, dims, ww: int, wh: int):
    """Positions (m, 2) (px, py) of the levels in arrays → (level index,
    oy, ox, nx, w0, count) a run, all levels checked and cut together."""
    sy, sx = wh // 2, ww // 2
    cnt = np.array([len(p) for _i, p in arrays])
    first = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    lvl = np.repeat(np.arange(len(arrays)), cnt)
    pos = np.concatenate([np.asarray(p, np.int64).reshape(-1, 2) for _i, p in arrays])
    px, py = pos[:, 0], pos[:, 1]
    ox, oy = np.minimum.reduceat(px, first), np.minimum.reduceat(py, first)
    dx, dy = px - ox[lvl], py - oy[lvl]
    if (dx % sx).any() or (dy % sy).any():
        raise ValueError(f"level positions off the grid of stride ({sy}, {sx})")
    dims = dims[[i for i, _p in arrays]]
    if (px + ww > dims[lvl, 1]).any() or (py + wh > dims[lvl, 0]).any():
        raise ValueError("level positions past their level")
    ix, iy = dx // sx, dy // sy
    nx = np.maximum.reduceat(ix, first) + 1
    q = iy * nx[lvl] + ix
    cut = np.ones(len(q), bool)
    cut[1:] = np.diff(q) != 1
    cut[first] = True
    runs = np.flatnonzero(cut)
    rl = lvl[runs]
    idx = np.array([i for i, _p in arrays])[rl]
    return np.column_stack([idx, oy[rl], ox[rl], nx[rl], q[runs],
                            np.diff(np.append(runs, len(q)))])


def pack_levels(levels, ww: int, wh: int, device, arena: SourceArena | None = None) -> Levels:
    """levels [(img, positions, key)] → Levels on device.

    positions: a ``GridRun`` (the reader's schedule levels), taken in
    O(1), or an (m, 2) (px, py) array, which must lie on its grid of
    stride (ww // 2, wh // 2) from its least px and py, inside the level;
    each run of consecutive grid indices (row-major over the level's nx
    columns) becomes one table row, so a schedule level (the partial
    first row and full rows after it) is one row either way, and the
    windows come out in the order given. A level without positions has
    no row. The arrays of all levels are checked and cut into runs
    together."""
    device = torch.device(device)
    arena = SourceArena(device) if arena is None else arena
    sy, sx = wh // 2, ww // 2
    counts = [len(lv[1]) for lv in levels]
    live = [lv for lv, c in zip(levels, counts) if c]
    lazy_src, eager_img = {}, {}
    for img, _pos, _key in live:
        src = getattr(img, "src", None)
        if src is not None:  # a LazyLevel
            lazy_src.setdefault((img.src_id, src.shape), src)
        else:
            eager_img.setdefault(id(img), np.asarray(img, np.uint8))
    lazy_off = arena.place(lazy_src)
    eager_off, eager_parts, at = {}, [], 0
    for key, a in eager_img.items():
        eager_off[key] = at
        eager_parts.append(a.reshape(-1))
        at += a.size
    # a row a level (src_off, eager, sh, sw, dh, dw, then oy, ox, nx, w0,
    # count of its GridRun, O(1), or zeros for positions cut below)
    heads, arrays = [], []
    for i, (img, pos, _key) in enumerate(live):
        src = getattr(img, "src", None)
        if src is not None:
            head = (lazy_off[img.src_id, src.shape], 0, *src.shape, img.h, img.w)
        else:
            head = (eager_off[id(img)], 1, *img.shape, *img.shape)
        if type(pos) is GridRun:
            # its row in O(1), as the array path gives it for the same
            # positions: from the run's first grid row, and cut to its
            # windows where it lies in one grid row
            if pos.sx != sx or pos.sy != sy:
                raise ValueError(f"level positions off the grid of stride ({sy}, {sx})")
            nx, first, n = pos.nx, pos.first, pos.count
            r0, c0 = divmod(first, nx)
            if r0 == (first + n - 1) // nx:
                heads.append((*head, pos.oy + r0 * sy, pos.ox + c0 * sx, n, 0, n))
            else:
                heads.append((*head, pos.oy + r0 * sy, pos.ox, nx, first - r0 * nx, n))
        else:
            heads.append((*head, 0, 0, 1, 0, 0))
            arrays.append((i, pos))
    shapes = tuple(tile_shape(ww, wh, k) for k in KINDS)
    tiles = [0 if shape else None for shape in shapes]
    table = np.zeros((0, len(LEVEL_COLS)), np.int64)
    if heads:
        hd = np.array(heads, np.int64)
        grid = hd[:, 10] > 0
        if grid.any():
            g = hd[grid]
            ends = g[:, 6] + ((g[:, 9] + g[:, 10] - 1) // g[:, 8]) * sy + wh
            right = g[:, 7] + (g[:, 8] - 1) * sx + ww
            if (ends > g[:, 4]).any() or (right > g[:, 5]).any():
                raise ValueError("level positions past their level")
        if arrays:  # the levels' runs, in level order
            runs = _array_rows(arrays, hd[:, 4:6], ww, wh)
            li = np.concatenate([np.flatnonzero(grid), runs[:, 0]])
            order = np.argsort(li, kind="stable")
            hd = np.concatenate([hd[grid], np.column_stack([hd[runs[:, 0], :6], runs[:, 1:]])])
            hd = hd[order]
        nx, w0, cnt = hd[:, 8], hd[:, 9], hd[:, 10]
        first_tile, done = [], {}
        for k, shape in enumerate(shapes):
            if shape not in done:
                per = run_tiles(nx, w0, cnt, *shape) if shape else np.zeros_like(cnt)
                done[shape] = np.cumsum(per) - per, int(per.sum())
            first_tile.append(done[shape][0])
            tiles[k] = done[shape][1] if shape else None
        table = np.column_stack([hd, np.cumsum(cnt) - cnt, *first_tile])
    count(SYNC, 2 if eager_parts else 1)
    eager = (torch.from_numpy(np.concatenate(eager_parts)).to(device) if eager_parts
             else torch.empty(0, dtype=torch.uint8, device=device))
    return Levels(torch.from_numpy(np.ascontiguousarray(table, np.int64)).to(device), arena.buf,
                  eager, int(sum(counts)), counts, shapes, tuple(tiles))


def exact_bound(feats: Features, ww: int, wh: int) -> int:
    """The largest sum of |coefficient| x |integral value| over the
    corners of one feature (Haar) or one cell (LBP): no partial sum of
    the plain version's f32 corner product can pass it. An upright
    integral at corner (y, x) is at most 255·y·x, a tilted one at most
    255·wh·ww."""
    stride = ww + 1
    if feats.points is not None:
        count(SYNC, 2)
        pts = feats.points.long()[:, torch.from_numpy(_CELL_POINTS).to(feats.points.device)]
        reach = (pts // stride) * (pts % stride) * PIXEL_MAX
        return int(reach.sum(dim=2).max()) if reach.numel() else 0
    count(SYNC)
    off = feats.offsets.long()
    reach = (off // stride) * (off % stride) * PIXEL_MAX
    reach = torch.where(feats.tilted.bool()[:, None, None], PIXEL_MAX * wh * ww, reach)
    per = (feats.weights.long().abs() * reach.sum(dim=2)).sum(dim=1)
    return int(per.max()) if per.numel() else 0


def check_exact(feats: Features, ww: int, wh: int):
    """Raise unless the f32 corner product is exact for these features:
    every partial sum within 2^24 (the kernel's integer sums agree with
    the plain version's f32 product only then)."""
    b = feats.bounds.get((ww, wh))
    if b is None:
        b = feats.bounds[ww, wh] = exact_bound(feats, ww, wh)
    if b > EXACT_LIMIT:
        raise ValueError(f"corner product not exact in f32: a partial sum may reach {b} > 2^24 "
                         f"at {wh}x{ww}")


def features_of(ev, used) -> Features:
    """The records of the used features (global indices) from a Haar or
    LBP training evaluator."""
    count(SYNC)
    sel = torch.as_tensor(np.asarray(used, np.int64), device=ev.device)
    if ev.maxCatCount > 0:
        return Features(points=ev.kernel_records(sel))
    off, w, til = ev.kernel_records(sel)
    count(SYNC)
    return Features(offsets=off, weights=w, tilted=til, has_tilted=bool(til.any()))


def tree_table(stages, used, categorical: bool, device) -> Trees:
    """Every tree of the stages (each a stump) flattened in order; feature
    rows index ``used``."""
    pos = {v: i for i, v in enumerate(used)}
    ti, tt, tl, tr, ts, ends, sthr = [], [], [], [], [], [], []
    for si, stage in enumerate(stages):
        if not stage.trees:
            raise ValueError(f"stage {si} has no trees")
        for tree in stage.trees:
            if tree.num_nodes != 1:
                raise ValueError("the dense miner takes stumps only")
            ti.append(pos[int(tree.feature_idx[0])])
            if categorical:
                ts.append(np.asarray(tree.subsets[0], np.int32))
                tt.append(0.0)
            else:
                tt.append(tree.threshold[0])
            tl.append(tree.leaf_values[-int(tree.left[0])] if tree.left[0] <= 0 else 0.0)
            tr.append(tree.leaf_values[-int(tree.right[0])] if tree.right[0] <= 0 else 0.0)
        ends.append(len(ti))
        sthr.append(float(stage.threshold))

    def t(a, dtype, shape=(-1,)):
        count(SYNC)
        return torch.as_tensor(np.asarray(a, dtype).reshape(shape), device=device)

    return Trees(t(ti, np.int32), t(tt, np.float32), t(tl, np.float32), t(tr, np.float32),
                 t(ts, np.int32, (-1, 8)) if categorical else None, t(ends, np.int32),
                 t(sthr, np.float64), len(used))


def walk_args(trees: Trees) -> tuple:
    """The tree table as ``predictor.stump_walk``'s arguments after vals."""
    be = trees.stage_end.long()
    bs = torch.cat([be.new_zeros(1), be[:-1]])
    return (trees.feature.long(), trees.thr, trees.left, trees.right, trees.subsets, bs, be,
            trees.stage_thr)


def _lbp_cells(points):
    """(K, 16) grid points → (9·K, 1, 4) cell corners, cell-major a feature."""
    return points[:, torch.from_numpy(_CELL_POINTS).to(points.device)].reshape(-1, 1, 4)


def level_windows(levels: Levels, ww: int, wh: int):
    """The windows of every table row, in output order, as one (n, wh, ww)
    uint8 tensor: each row's grid built (lazy: ``build_level`` from its
    source) or cut (eager) down to its last window's row."""
    sy, sx = wh // 2, ww // 2
    parts = []
    count(SYNC)
    for r in levels.table.tolist():
        nx, w0, cnt = r[NX], r[W0], r[COUNT]
        ny = (w0 + cnt - 1) // nx + 1
        hs, ws = sy * (ny - 1) + wh, sx * (nx - 1) + ww
        if r[EAGER]:
            img = levels.eager[r[SRC_OFF]:r[SRC_OFF] + r[SH] * r[SW]].view(r[SH], r[SW])
            slot = img[r[OY]:r[OY] + hs, r[OX]:r[OX] + ws]
        else:
            src = levels.lazy[r[SRC_OFF]:r[SRC_OFF] + r[SH] * r[SW]].view(r[SH], r[SW])
            slot = build_level(src, r[SH], r[SW], r[DH], r[DW], r[OY], r[OX], hs, ws)
        grid = slot.unfold(0, wh, sy).unfold(1, ww, sx).reshape(-1, wh, ww)
        parts.append(grid[w0:w0 + cnt])
    if not parts:
        return torch.zeros((0, wh, ww), dtype=torch.uint8, device=levels.table.device)
    return torch.cat(parts)


def mine_ref(levels: Levels, feats: Features, trees: Trees, ww: int, wh: int):
    """Plain version of ``mine``: → (n,) uint8, 1 where every stage accepts."""
    from cascadeclassifier_tpu_torch.train.predictor import stump_walk

    dev = levels.table.device
    if levels.n == 0 or trees.stage_end.numel() == 0:
        return torch.ones(levels.n, dtype=torch.uint8, device=dev)
    p = (ww + 1) * (wh + 1)
    if feats.points is not None:
        m_cells = corner_matrix(_lbp_cells(feats.points),
                                torch.ones((9 * feats.count, 1), device=dev), p)

        def values(win):
            return LBPTrainEvaluator.codes(m_cells, lbp_rows(win))
    else:
        w = feats.weights.to(torch.float32)
        til = feats.tilted.bool()
        up = ~til
        m_up = corner_matrix(feats.offsets * up[:, None, None], w * up[:, None], p)
        m_tilt = (corner_matrix(feats.offsets * til[:, None, None], w * til[:, None], p)
                  if feats.has_tilted else None)

        def values(win):
            rows, nf = haar_rows(win)
            raw = f32_matmul(m_up, rows.T)
            if m_tilt is not None:  # up + tilted, then the division
                t = integral_tilted(win)
                raw = raw + f32_matmul(m_tilt, t.reshape(t.shape[0], -1).to(torch.float32).T)
            return divide_nf(raw, nf)

    args = walk_args(trees)
    wins = level_windows(levels, ww, wh)
    oks = [stump_walk(values(wins[c0:c0 + CHUNK_WINDOWS]), *args)
           for c0 in range(0, wins.shape[0], CHUNK_WINDOWS)]
    return torch.cat(oks).to(torch.uint8)


def _check_args(levels: Levels, feats: Features, trees: Trees, ww: int, wh: int):
    dev = levels.table.device
    _build.require(levels.table, torch.int64, 2, "table", dev)
    if levels.table.shape[1] != len(LEVEL_COLS):
        raise ValueError(f"table: {levels.table.shape[1]} columns, expected {len(LEVEL_COLS)}")
    _build.require(levels.lazy, torch.uint8, 1, "lazy", dev)
    _build.require(levels.eager, torch.uint8, 1, "eager", dev)
    if ww < 2 or wh < 2:
        raise ValueError(f"window {wh}x{ww}: each side at least 2")
    if feats.points is not None:
        _build.require(feats.points, torch.int32, 2, "points", dev)
    else:
        _build.require(feats.offsets, torch.int32, 3, "offsets", dev)
        _build.require(feats.weights, torch.int32, 2, "weights", dev)
        _build.require(feats.tilted, torch.int32, 1, "tilted", dev)
    t = trees.feature.shape[0]
    for name, dtype in (("feature", torch.int32), ("thr", torch.float32),
                        ("left", torch.float32), ("right", torch.float32)):
        _build.require(getattr(trees, name), dtype, 1, name, dev)
        if getattr(trees, name).shape[0] != t:
            raise ValueError(f"trees.{name}: {getattr(trees, name).shape[0]} trees, expected {t}")
    _build.require(trees.stage_end, torch.int32, 1, "stage_end", dev)
    _build.require(trees.stage_thr, torch.float64, 1, "stage_thr", dev)
    if (feats.points is not None) != (trees.subsets is not None):
        raise ValueError("LBP features need subsets, Haar features thresholds")
    if trees.subsets is not None:
        _build.require(trees.subsets, torch.int32, 2, "subsets", dev)
    if trees.n_features != feats.count:
        raise ValueError(f"trees index {trees.n_features} features, got {feats.count} records")
    if t > MAX_TREES:
        raise ValueError(f"{t} trees: the kernel's scan carries at most {MAX_TREES}")
    check_exact(feats, ww, wh)


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _tree_args(feats: Features, trees: Trees) -> tuple:
    return (feats.kind, _ptr(feats.offsets), _ptr(feats.weights), _ptr(feats.tilted),
            _ptr(feats.points), trees.feature.data_ptr(), trees.thr.data_ptr(),
            trees.left.data_ptr(), trees.right.data_ptr(), _ptr(trees.subsets),
            trees.feature.shape[0], trees.stage_end.data_ptr(), trees.stage_thr.data_ptr(),
            trees.stage_end.shape[0])


def tile_args(levels: Levels, feats: Features, trees: Trees, ww: int, wh: int, out) -> tuple:
    """cct_mine's arguments for these levels, trees and the (n,) out."""
    return (levels.table.data_ptr(), levels.table.shape[0], levels.tiles[feats.kind],
            *levels.shapes[feats.kind], HAND_LIVE, levels.lazy.data_ptr(),
            levels.eager.data_ptr(), ww, wh, *_tree_args(feats, trees), out.data_ptr(), levels.n,
            _build.stream_of(out))


def mine(levels: Levels, feats: Features, trees: Trees, ww: int, wh: int, impl: str = "auto"):
    """(n,) uint8 accept mask of every window of the levels (1: every
    stage accepts), in the levels' order; one launch of csrc/mine.cu's
    tile kernel on a CUDA device (raises where ``check_exact`` fails or
    no tile fits the window), ``mine_ref`` on the CPU or with
    impl="ref"."""
    if _build.use_ref(levels.table, impl):
        return mine_ref(levels, feats, trees, ww, wh)
    _check_args(levels, feats, trees, ww, wh)
    shape = levels.shapes[feats.kind]
    if shape is None:
        raise ValueError(f"window {wh}x{ww}: one window's tile passes a CTA's shared memory")
    dev = levels.table.device
    out = torch.empty(levels.n, dtype=torch.uint8, device=dev)
    if levels.n == 0:
        return out
    code = _build.lib().cct_mine(*tile_args(levels, feats, trees, ww, wh, out))
    _build.check(code, "cct_mine")
    _build.LAUNCHES["mine"] += 1
    return out


def mine_warp(levels: Levels, feats: Features, trees: Trees, ww: int, wh: int):
    """``mine`` by the design the tile kernel replaced (csrc/mine.cu's
    warp_kernel: a warp a window), on a CUDA device only; timed beside
    ``mine`` by utils/time_mine.py, never on the miner's path."""
    if levels.table.device.type != "cuda":
        raise ValueError("mine_warp runs on a CUDA device only")
    _check_args(levels, feats, trees, ww, wh)
    out = torch.empty(levels.n, dtype=torch.uint8, device=levels.table.device)
    if levels.n == 0:
        return out
    code = _build.lib().cct_mine_warp(
        levels.table.data_ptr(), levels.table.shape[0], levels.lazy.data_ptr(),
        levels.eager.data_ptr(), ww, wh, *_tree_args(feats, trees), out.data_ptr(), levels.n,
        _build.stream_of(out))
    _build.check(code, "cct_mine_warp")
    _build.LAUNCHES["mine_warp"] += 1
    return out


def tile_info(ww: int, wh: int, kind: int) -> dict:
    """The tile kernel's shape for this window and kind, its shared bytes
    a CTA by the source's layout and by ``tile_layout``, and the CTAs an
    SM holds (CUDA occupancy API); needs the built library."""
    import ctypes

    shape = tile_shape(ww, wh, kind)
    if shape is None:
        raise ValueError(f"window {wh}x{ww}: no tile fits")
    nbytes, ctas = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.lib().cct_mine_info(ww, wh, kind, *shape, ctypes.byref(nbytes),
                                            ctypes.byref(ctas)), "cct_mine_info")
    return {"tile": shape, "shared_bytes": nbytes.value,
            "layout_bytes": 4 * tile_layout(ww, wh, kind, *shape)["ints"],
            "ctas_per_sm": ctas.value}
