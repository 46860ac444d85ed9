"""Packed tree records and the window tiles of the front and stage kernels.

``csrc/front.cu`` and ``csrc/stage.cu`` give one thread block a tile of
``TILE_H`` x ``TILE_W`` canvas windows. The block copies the (TILE_H +
win_h) x (TILE_W + win_w) patch of the integral canvas that those
windows read into shared memory, rows ``tile_pitch(win_w)`` cells apart,
and for a cascade with tilted trees the same patch of the tilted canvas
right behind it. A cascade reaches the kernels in one of three kinds
(``KINDS``, ``PackedCascade.kind``), each with its record form.

"stump" (stump Haar): one 48-byte record (``RECORD``) a tree: per weighted
rect its four corners as cell offsets from the window's own cell in that
shared-memory image, the rect weights, and the stump's threshold and
leaves.

  corner[r] = (c0, c1, c2, c3) with rect sum = c0 - c1 - c2 + c3
      upright (x, y, w, h): (x, y), (x+w, y), (x, y+h), (x+w, y+h)
      tilted:               (x, y), (x-h, y+h), (x+w, y+w), (x+w-h, y+w+h),
                            each plus ``tilt_bias`` (the tilted patch's
                            offset from the integral patch)
  weight[r] = the rect's weight; the weighted rects come first, in their
      order, and the unused slots hold weight 0 and corners 0, so the
      count of weighted rects is the count of leading nonzero weights
  thr, left, right = the stump

"node" (Haar node trees: a cascade with any tree of more than one
internal node; its stump trees too): one 48-byte ``NODE_RECORD`` a node,
the corners, weights and thr of ``RECORD`` with two child codes in place
of the leaves. "lbp" (LBP stumps or node trees): one 80-byte
``LBP_RECORD`` a node,

  corner[4j + i] = the cell offset of grid point (x + i*w, y + j*h),
      i, j in 0..3, of the feature's 3 x 3 cells of w x h
  subset[8] = the categorical split's bit mask over the 256 codes
  left, right = the child codes

Both node forms come with ``tree_root`` (T,) int32, each tree's root as a
record index, and ``leaves`` (L,) f32, the leaf table. A child code c >= 0
is the record index of an internal node, c < 0 the leaf ~c: a tree's BFS
code k > 0 (node k) becomes root + k and a code k <= 0 (leaf -k) becomes
~(leaf base + (-k)). The nodes of every tree follow its root, the trees
in cascade order; a stump is a tree of one node and two leaves.

The kernels read a record as 16-byte words. Everything here is numpy;
``records_stage_pass`` and ``node_records_stage_pass`` repeat the
kernels' per-tile arithmetic on the CPU, so that the tests can hold the
encodings against ``dense.stage_pass``.
"""

from __future__ import annotations

import numpy as np

TILE_H = 16  # csrc/cascade_tile.cuh: CCT_STAGE_TILE_H, CCT_FRONT_TILE_H
TILE_W = 128  # csrc/cascade_tile.cuh: kTileW
PITCHES = (152, 200, 264)  # csrc/cascade_tile.cuh: the pitches dispatch() instantiates
SHARED_BYTES = 232448  # the most dynamic shared memory a block of the H100 takes
KINDS = {"stump": 0, "node": 1, "lbp": 2}  # csrc/cascade_tile.cuh: cct::Kind

RECORD = np.dtype([
    ("corner", "<u2", (3, 4)),
    ("weight", "<f4", (3,)),
    ("thr", "<f4"),
    ("left", "<f4"),
    ("right", "<f4"),
])
assert RECORD.itemsize == 48
NODE_RECORD = np.dtype([
    ("corner", "<u2", (3, 4)),
    ("weight", "<f4", (3,)),
    ("thr", "<f4"),
    ("left", "<i4"),
    ("right", "<i4"),
])
assert NODE_RECORD.itemsize == 48
LBP_RECORD = np.dtype([
    ("corner", "<u2", (16,)),
    ("subset", "<i4", (8,)),
    ("left", "<i4"),
    ("right", "<i4"),
    ("pad", "<i4", (2,)),
])
assert LBP_RECORD.itemsize == 80


def tile_pitch(win_w: int) -> int:
    """Cells between two rows of the shared-memory patch: the least
    compiled pitch that holds TILE_W + win_w columns."""
    for pitch in PITCHES:
        if TILE_W + win_w <= pitch:
            return pitch
    raise ValueError(f"window width {win_w} exceeds the kernels' widest tile "
                     f"({PITCHES[-1] - TILE_W})")


def tilt_bias(win_w: int, win_h: int) -> int:
    """Cell offset of the tilted patch from the integral patch."""
    return (TILE_H + win_h) * tile_pitch(win_w)


def check_tile(win_w: int, win_h: int, tilted: bool):
    """The kernels' tile for a window: its shared memory (the patch, twice
    with the tilted one, the two window lists and the byte mask) within
    SHARED_BYTES, and every corner offset within 16 bits."""
    pitch = tile_pitch(win_w)
    patches = 2 if tilted else 1
    need = patches * (TILE_H + win_h) * pitch * 4 + TILE_H * TILE_W * 5
    if need > SHARED_BYTES:
        raise ValueError(f"a {win_w}x{win_h} window's tile needs {need} bytes of shared "
                         f"memory, more than {SHARED_BYTES}")
    if patches * tilt_bias(win_w, win_h) > 1 << 16:
        raise ValueError(f"a {win_w}x{win_h} window's tile does not fit 16-bit corner offsets")


def corner_cells(x: int, y: int, w: int, h: int, tilted: bool):
    """The four (dx, dy) corners of a rect, in the order c0 - c1 - c2 + c3."""
    if tilted:
        return (x, y), (x - h, y + h), (x + w, y + w), (x + w - h, y + w + h)
    return (x, y), (x + w, y), (x, y + h), (x + w, y + h)


def _haar_slots(rec, t, rects, weights, tilted, pitch, bias):
    """Fill record t's corner and weight slots from (x, y, w, h) rects and
    their weights; weight-0 rects are dropped."""
    slot = 0
    for (x, y, w, h), wt in zip(rects, weights):
        if wt == 0:
            continue
        cells = corner_cells(int(x), int(y), int(w), int(h), tilted)
        rec["corner"][t, slot] = [dy * pitch + dx + bias * tilted for dx, dy in cells]
        rec["weight"][t, slot] = wt
        slot += 1


def tree_records(stages, win_w: int, win_h: int) -> np.ndarray:
    """Every tree of the stages, in order, as a (T,) RECORD array."""
    pitch = tile_pitch(win_w)
    check_tile(win_w, win_h, any(st.tilted.any() for st in stages))
    bias = tilt_bias(win_w, win_h)
    if any(st.ntrees == 0 for st in stages):
        raise ValueError("a stage without trees")
    rec = np.zeros(sum(st.ntrees for st in stages), RECORD)
    t = 0
    for st in stages:
        for i in range(st.ntrees):
            _haar_slots(rec, t, st.feat_rects[i], st.weights[i], bool(st.tilted[i]), pitch, bias)
            rec["thr"][t] = st.thr[i]
            rec["left"][t] = st.left_leaf[i]
            rec["right"][t] = st.right_leaf[i]
            t += 1
    return rec


def _tree_nodes(st, i, lbp: bool):
    """Tree i of a stage as (left codes, right codes, per-node feature,
    thresholds or subsets, leaves): its BFS arrays for a node tree, one
    node and two leaves for a stump. A feature is ((x, y, w, h) rects,
    weights, tilted) for Haar and the cell rect for LBP."""
    if st.deep_trees is not None:
        tree, feats = st.deep_trees[i]
        if lbp:
            node_feats = [f.rect for f in feats]
            split = tree.subsets
        else:
            node_feats = [([r[:4] for r in f.rects], [r[4] for r in f.rects], bool(f.tilted))
                          for f in feats]
            split = tree.threshold
        return tree.left, tree.right, node_feats, split, tree.leaf_values
    left, right = np.array([0]), np.array([-1])
    leaves = np.array([st.left_leaf[i], st.right_leaf[i]], np.float32)
    if lbp:
        return left, right, [st.lbp_rects[i]], st.subsets[i : i + 1], leaves
    feat = (st.feat_rects[i], st.weights[i], bool(st.tilted[i]))
    return left, right, [feat], st.thr[i : i + 1], leaves


def node_tables(stages, win_w: int, win_h: int, lbp: bool, has_tilted: bool):
    """Every tree of the stages as node records → (rec (N,) NODE_RECORD or
    LBP_RECORD, tree_root (T,) int32, leaves (L,) float32)."""
    pitch = tile_pitch(win_w)
    check_tile(win_w, win_h, has_tilted)
    bias = tilt_bias(win_w, win_h)
    if any(st.ntrees == 0 for st in stages):
        raise ValueError("a stage without trees")
    trees = [_tree_nodes(st, i, lbp) for st in stages for i in range(st.ntrees)]
    rec = np.zeros(sum(len(t[0]) for t in trees), LBP_RECORD if lbp else NODE_RECORD)
    roots, leaves = [], []
    n = 0
    for left, right, feats, split, leaf_values in trees:
        root, base = n, len(leaves)

        def code(c):
            c = int(c)
            return root + c if c > 0 else ~(base - c)

        for k, feat in enumerate(feats):
            if lbp:
                x, y, w, h = (int(v) for v in feat)
                rec["corner"][n] = [(y + j * h) * pitch + x + i * w
                                    for j in range(4) for i in range(4)]
                rec["subset"][n] = split[k]
            else:
                rects, weights, tilted = feat
                _haar_slots(rec, n, rects, weights, tilted, pitch, bias)
                rec["thr"][n] = split[k]
            rec["left"][n], rec["right"][n] = code(left[k]), code(right[k])
            n += 1
        roots.append(root)
        leaves.extend(np.asarray(leaf_values, np.float32).tolist())
    return rec, np.array(roots, np.int32), np.array(leaves, np.float32)


def decode_records(rec: np.ndarray, win_w: int, win_h: int) -> dict:
    """The records back as PackedStage's arrays over all trees:
    feat_rects (T, 3, 4), weights (T, 3), tilted (T,), thr, left_leaf,
    right_leaf (T,). Unused rect slots decode to zeros."""
    pitch = tile_pitch(win_w)
    bias = tilt_bias(win_w, win_h)
    corner = rec["corner"].astype(np.int64)
    used = rec["weight"] != 0
    tilted = (used & (corner[:, :, 0] >= bias)).any(axis=1)
    corner = corner - bias * tilted[:, None, None]
    cy, cx = corner // pitch, corner % pitch
    x, y = cx[:, :, 0], cy[:, :, 0]
    # upright: c1 = (x+w, y), c2 = (x, y+h); tilted: c2 = (x+w, y+w), c1 = (x-h, y+h)
    w = np.where(tilted[:, None], cx[:, :, 2] - x, cx[:, :, 1] - x)
    h = np.where(tilted[:, None], cy[:, :, 1] - y, cy[:, :, 2] - y)
    rects = np.stack([x, y, w, h], axis=2) * used[:, :, None]
    return dict(feat_rects=rects.astype(np.int32), weights=rec["weight"].copy(),
                tilted=tilted, thr=rec["thr"].copy(), left_leaf=rec["left"].copy(),
                right_leaf=rec["right"].copy())


def tile_cover(out_h: int, out_w: int) -> list:
    """(r0, c0, rows, cols) of every tile of the kernels' grid: tile
    (by, bx) starts at window (by * TILE_H, bx * TILE_W) and the tiles at
    the right and bottom edges are cut to the windows that exist."""
    return [
        (r0, c0, min(TILE_H, out_h - r0), min(TILE_W, out_w - c0))
        for r0 in range(0, out_h, TILE_H)
        for c0 in range(0, out_w, TILE_W)
    ]


def _tile_images(canvases, r0, c0, win_w, win_h):
    """The tile's shared-memory image as the kernels copy it: each canvas's
    patch, rows tile_pitch apart, zeros past the canvas, one flat uint32
    array (the tilted patch behind the integral one)."""
    pitch = tile_pitch(win_w)
    rows = TILE_H + win_h
    image = np.zeros((len(canvases), rows, pitch), np.uint32)
    for k, canvas in enumerate(canvases):
        patch = canvas[r0 : r0 + rows, c0 : c0 + TILE_W + win_w]
        image[k, : patch.shape[0], : patch.shape[1]] = patch.view(np.uint32)
    return image.reshape(-1)


def _haar_value(flat, cell, node, inv):
    """A Haar record's raw * inv at the cells: sums in uint32 read as
    int32, f32 arithmetic in the kernels' order."""
    raw = None
    for r in range(3):
        wt = node["weight"][r]
        if wt == 0:
            break
        c = node["corner"][r].astype(np.int64)
        u = flat[cell + c[0]] - flat[cell + c[1]] - flat[cell + c[2]] + flat[cell + c[3]]
        term = u.view(np.int32).astype(np.float32) * wt
        raw = term if raw is None else raw + term
    if raw is None:
        raw = np.zeros(cell.shape, np.float32)
    return raw * inv


def _lbp_left(flat, cell, node):
    """An LBP record's split at the cells: True where the code's subset bit
    is set."""
    p = [flat[cell + int(c)] for c in node["corner"]]
    cs = [[(p[4 * r + c] - p[4 * r + c + 1] - p[4 * r + c + 4] + p[4 * r + c + 5]).view(np.int32)
           for c in range(3)] for r in range(3)]
    code = np.zeros(cell.shape, np.int32)
    for r, c, bit in ((0, 0, 128), (0, 1, 64), (0, 2, 32), (1, 2, 16),
                      (2, 2, 8), (2, 1, 4), (2, 0, 2), (1, 0, 1)):
        code |= np.where(cs[r][c] >= cs[1][1], bit, 0).astype(np.int32)
    word = node["subset"][code >> 5]
    return ((word >> (code & 31)) & 1) != 0


def _tile_pass(canvases, inv_nf, stage_thr, win_w, win_h, exact, tree_leaves):
    """One stage at every window, tile by tile: tree_leaves(flat, cell,
    inv) yields each tree's (TILE_H, TILE_W) f32 leaves in tree order; the
    sum in f32, or in f64 from leaves widened before each add."""
    pitch = tile_pitch(win_w)
    out_h, out_w = inv_nf.shape
    acc = np.float64 if exact else np.float32
    cell = (np.arange(TILE_H)[:, None] * pitch + np.arange(TILE_W)[None, :]).astype(np.int64)
    passed = np.zeros((out_h, out_w), bool)
    for r0, c0, th, tw in tile_cover(out_h, out_w):
        flat = _tile_images(canvases, r0, c0, win_w, win_h)
        inv = np.ones((TILE_H, TILE_W), np.float32)
        inv[:th, :tw] = inv_nf[r0 : r0 + th, c0 : c0 + tw]
        ssum = np.zeros((TILE_H, TILE_W), acc)
        for leaf in tree_leaves(flat, cell, inv):
            ssum = ssum + leaf.astype(acc)
        passed[r0 : r0 + th, c0 : c0 + tw] = (ssum >= acc(np.float32(stage_thr)))[:th, :tw]
    return passed


def records_stage_pass(rec, stage_thr, sum2d, tilt2d, inv_nf, win_w: int, win_h: int,
                       exact: bool = False):
    """One stage (its trees' RECORDs, in order) at every window, tile by
    tile as the kernels do it: the patches copied into one flat image
    (zeros past the canvas), every corner read at window cell + record
    offset, sums in uint32 read as int32, f32 arithmetic in the kernels'
    order, the stage sum in f32 or (exact) f64. sum2d, tilt2d (canvas_h,
    canvas_w) int32 numpy (tilt2d may be None when no tree is tilted);
    inv_nf (out_h, out_w) f32 → bool mask."""
    canvases = [sum2d] if tilt2d is None else [sum2d, tilt2d]

    def leaves(flat, cell, inv):
        for tree in rec:
            val = _haar_value(flat, cell, tree, inv)
            yield np.where(val < tree["thr"], tree["left"], tree["right"])

    return _tile_pass(canvases, inv_nf, stage_thr, win_w, win_h, exact, leaves)


def node_records_stage_pass(tables, stage_thr, sum2d, tilt2d, inv_nf, win_w: int,
                            win_h: int, exact: bool = False):
    """records_stage_pass for node records: tables = (rec, tree_root,
    leaves) of one stage's trees (``node_tables``), NODE_RECORD (Haar) or
    LBP_RECORD. Every window walks each tree from its root to a leaf as the
    kernels do; inv_nf is not read for LBP (may be None)."""
    rec, roots, leaf_table = tables
    lbp = rec.dtype == LBP_RECORD
    canvases = [sum2d] if tilt2d is None else [sum2d, tilt2d]
    if inv_nf is None:
        inv_nf = np.ones((sum2d.shape[0] - win_h, sum2d.shape[1] - win_w), np.float32)

    def leaves(flat, cell, inv):
        for root in roots:
            code = np.full(cell.shape, root, np.int64)
            while (code >= 0).any():
                for n in np.unique(code[code >= 0]):
                    node = rec[n]
                    at = code == n
                    if lbp:
                        left = _lbp_left(flat, cell, node)
                    else:
                        left = _haar_value(flat, cell, node, inv) < node["thr"]
                    code = np.where(at, np.where(left, node["left"], node["right"]), code)
            yield leaf_table[~code]

    return _tile_pass(canvases, inv_nf, stage_thr, win_w, win_h, exact, leaves)
