"""Edge cases of the tiled front, packed front and stage kernels, of the
tilted kernel and of the integral kernel against their twins.

Front and stage: small one-block canvases whose window grid is one less
than, equal to and one more than two tiles each way; masks that leave
every tile dead, every window alive, one window alive in the last row and
column, and a checkerboard. The packed front takes the same and a grid
one column wider than a listed block, each with six block lists
(``block_lists``). The pixels are a synthetic frame (``utils/synth.py``,
integer-only numpy, seeded by the frame number), taken through the
port's own integral, tilted integral and variance gate on the given
device. The tilted kernel takes random canvases with runs of rows around
its chunks and widths around its strips (``tilted_edge_cases``). The
integral kernel takes random canvases of heights around its bands and
widths around a warp and its passes, as uint8 and as int32 with values up
to 2^20, so that both sums wrap (``integral_edge_cases``).

The tile kernel's other policies take the same shapes and masks with f32
and f64 stage sums (``policy_edge_cases``): the frontal face and the upper
body in f64, Haar node trees (alt2, and the tilted 3-node eye_tree cut to
its first stages), LBP stumps (the LBP frontal face), a hand-built LBP
cascade of 2-node trees (``lbp_two_node_model``) and a hand-built stump
cascade whose stage threshold lies between the f32 and the f64 sums of
its leaves (``knife_edge_model``), where the two modes must differ.
The categorical split kernel (``csrc/cat_split.cu``) takes code blocks at
sample counts around its tree's levels (31/32/33, 1 023/1 024/1 025,
32 767/32 768/32 769), each with a feature of uniform codes holding a
window of one code, a feature of 4 codes, a feature all in one category
and a feature of skewed codes; and skewed blocks of one feature less than,
as many as and one more than one launch's warps (``cat_split_edge_cases``).
The HOG kernels (``csrc/hog_hist.cu``, ``csrc/hog_eval.cu``) take windows
of sides around their runs of 16 and the largest the wrapper takes, whose
planes need one channel group each (``HOG_SIDES``): a flat window, a
vertical and a horizontal step edge, ±255 gradients at each border, a
window of noise, for each of the 18 bin edges of the angle (9 mod π),
a window of 3x3 stencils whose centre gradients lie on and beside the edge
at three radii, and batches of 1, 3 and 5 windows of noise, which leave a
CTA's windows part full and start spans unaligned (``hog_edge_cases``);
``hog_eval`` also takes, on the noise, variable lists unsorted and
repeated (short, and longer than its plan-free limit), of one variable,
and of one feature's 36 shuffled (``hog_id_cases``).
The two-class split kernel (``csrc/split_class.cu``) takes blocks of 1, 15,
16 and 17 samples and around its chunks and scan levels, one feature and
an odd count of features, sample counts on both sides of its shared-memory
table, a block with every sample masked out, one class only, every value
equal, values of ±0.0, a kept position carried over a fully masked chunk
and exact ties across blocks and a chunk's edge, in both policies and both
layouts (``class_split_edge_cases``).
``chip_smoke.py`` and the card's tests run the same cases.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
import torch

from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import (
    APPLY_COLS,
    APPLY_THREADS,
    BAND_ROWS,
    integral,
)
from cascadeclassifier_tpu_torch.detect.packed_front import (
    BLK_W,
    block_grid,
    live_block_list,
    packed_front,
)
from cascadeclassifier_tpu_torch.detect.records import TILE_H, TILE_W
from cascadeclassifier_tpu_torch.detect.stage import stage
from cascadeclassifier_tpu_torch.detect.tilted import CHUNK_ROWS, STRIP_COLS, tilted
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
from cascadeclassifier_tpu_torch.ops.features import N_BINS, hog_catalog
from cascadeclassifier_tpu_torch.ops.hog import hog_integral_histogram, hog_responses
from cascadeclassifier_tpu_torch.train.cat_split import (
    categorical_class_split,
    categorical_split,
    wave_features,
)
from cascadeclassifier_tpu_torch.utils.synth import synth_frame

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

SHAPES = tuple((2 * TILE_H + d, 2 * TILE_W + d) for d in (-1, 0, 1))
FRONT_RANGES = ((1, 8), (3, 5), (4, 4))
STAGE_RANGES = ((0, 30), (0, 1), (1, 30), (5, 9))
# the last grid crosses a listed block's right edge by one column
PACKED_SHAPES = SHAPES + ((2 * TILE_H + 1, BLK_W + 1),)
PACKED_RANGES = ((1, 8), (4, 4))
# Runs of canvas rows, each but the first led by its top. Computed rows: 3
# (row 0 is no top), 0 (a top alone), 1, 2, one short of a chunk, a chunk,
# one past it, two chunks and two rows, and 0 (a top in the last row).
TILTED_RUNS = (3, 1, 2, 3, CHUNK_ROWS, CHUNK_ROWS + 1, CHUNK_ROWS + 2, 2 * CHUNK_ROWS + 3, 1)
TILTED_WIDTHS = (1, 37, STRIP_COLS - 1, STRIP_COLS, STRIP_COLS + 1, 2 * STRIP_COLS - 1,
                 2 * STRIP_COLS + 1)
TILTED_PADS = (0, 3, 2 * CHUNK_ROWS + 4, 500)  # the third: the tallest run's rows + 1, exact
# one band, one row short of, at and one past a band, and three bands and a
# part; one column, one short of, at and past a warp, the 1080p and 4K
# canvas widths, and at and past one pass of the apply kernel
INTEGRAL_HEIGHTS = (1, BAND_ROWS - 1, BAND_ROWS, BAND_ROWS + 1, 3 * BAND_ROWS + 5)
INTEGRAL_WIDTHS = (1, 31, 32, 33, 1921, 3841, APPLY_THREADS * APPLY_COLS,
                   APPLY_THREADS * APPLY_COLS + 1)
# around a window of 32, one level (1 024) and two levels (32 768) of the
# categorical kernel's tree; the trainer's padded sample count
CAT_NS = (31, 32, 33, 1023, 1024, 1025, 32767, 32768, 32769)
CAT_TRAIN_N = 3072


def edge_masks(out_h: int, out_w: int, device) -> dict:
    """name → (out_h, out_w) bool alive mask."""
    last = torch.zeros((out_h, out_w), dtype=torch.bool, device=device)
    last[-1, -1] = True
    rows = torch.arange(out_h, device=device)[:, None]
    cols = torch.arange(out_w, device=device)[None, :]
    return {
        "all dead": torch.zeros_like(last),
        "all alive": torch.ones_like(last),
        "last window": last,
        "checkerboard": ((rows + cols) & 1) == 0,
    }


def edge_inputs(k: int, out_h: int, out_w: int, cascade, device, with_tilted: bool):
    """Frame k as one pyramid block of out_h x out_w windows → (sum2d,
    tilt2d, inv_nf); tilt2d is sum2d unless with_tilted."""
    canvas_h, canvas_w = out_h + cascade.win_h, out_w + cascade.win_w
    px = np.zeros((canvas_h, canvas_w), np.int32)
    px[1:, 1:] = synth_frame(k, canvas_h - 1, canvas_w - 1)
    px = torch.from_numpy(px).to(device)
    sum2d, sq2d = integral(px)
    tilt2d = sum2d
    if with_tilted:
        is_top = np.zeros(canvas_h, bool)
        is_top[0] = True
        tilt2d = tilted(px, is_top, canvas_h + 1)
    _, inv_nf = dense_variance_gate(sum2d, sq2d, cascade.win_w, cascade.win_h, out_h, out_w)
    return sum2d, tilt2d, inv_nf


def edge_mismatches(cascade, ranges, device, use_stage: bool, exact: bool = False):
    """Runs every shape x mask x stage range through the kernel (on a
    CUDA device) and through its twin → (cases run, survivors summed
    over the cases, descriptions of the cases that differ). use_stage:
    the stage kernel (alive and passed0), with the tilted canvas when the
    cascade has tilted trees and sum2d in its place otherwise; else the
    front kernel. exact: f64 stage sums; an LBP cascade gets no inv_nf."""
    n, survivors, bad = 0, 0, []
    for k, (out_h, out_w) in enumerate(SHAPES):
        sum2d, tilt2d, inv_nf = edge_inputs(k, out_h, out_w, cascade, device,
                                            use_stage and cascade.has_tilted)
        if cascade.is_lbp:
            inv_nf = None
        for name, alive in edge_masks(out_h, out_w, device).items():
            for s0, s1 in ranges:
                if use_stage:
                    args = (sum2d, tilt2d, inv_nf, alive, cascade, s0, s1)
                    got = stage(*args, exact=exact)
                    want = stage(*args, impl="ref", exact=exact)
                else:
                    args = (sum2d, inv_nf, alive, cascade, s0, s1)
                    got = (front(*args, exact=exact),)
                    want = (front(*args, impl="ref", exact=exact),)
                n += 1
                survivors += int(got[0].sum())
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    bad.append(f"{out_h}x{out_w} windows, {name}, stages [{s0}, {s1})")
    return n, survivors, bad


def knife_threshold() -> np.float32:
    """An XML stage threshold whose effective value (less 1e-5 in f32) is
    1 + 2^-23, the f32 number after 1."""
    eps = np.float32(1e-5)
    target = np.float32(1.0) + np.float32(2.0 ** -23)
    t = np.float32(target + eps)
    assert np.float32(t - eps) == target
    return t


def _classes(base):
    """base's own Stage and WeakTree classes: the model functions below take a
    model of either package (the tests write the JAX package's as XML)."""
    return type(base.stages[0]), type(base.stages[0].trees[0])


def _stump(tree_cls, feature, thr, left, right):
    return tree_cls(left=np.array([0], np.int32), right=np.array([-1], np.int32),
                    feature_idx=np.array([feature], np.int32),
                    threshold=np.array([thr], np.float32),
                    leaf_values=np.array([left, right], np.float32))


def knife_edge_model(base):
    """One stage of five stumps on the first two features of base's stage
    0 (a 20x20 upright Haar cascade), leaves chosen so that the f32 and the
    f64 stage sums differ: tree 0 gives 1 (left) or 0, tree 1 gives 2^-22
    (left) or 2^-25, trees 2-4 always 2^-25, and the effective stage
    threshold is 1 + 2^-23. Where trees 0 and 1 go left both sums pass;
    where tree 0 goes left and tree 1 right the f32 sum stays at 1 (each
    2^-25 is a quarter of an f32 step there and rounds away) and fails,
    while the f64 sum reaches 1 + 2^-23 and passes, as OpenCV's double
    sum does; elsewhere both fail."""
    stage_cls, tree_cls = _classes(base)
    t0, t1 = base.stages[0].trees[:2]
    feats = [base.features[int(t.feature_idx[0])] for t in (t0, t1)]
    tiny = np.float32(2.0 ** -25)
    trees = [_stump(tree_cls, 0, t0.threshold[0], 1.0, 0.0),
             _stump(tree_cls, 1, t1.threshold[0], np.float32(2.0 ** -22), tiny)]
    trees += [_stump(tree_cls, 0, t0.threshold[0], tiny, tiny) for _ in range(3)]
    stage = stage_cls(threshold=float(knife_threshold()), trees=trees)
    return dataclasses.replace(base, stages=[stage], features=feats)


def lbp_two_node_model(base, n_stages: int = 3):
    """base's (an LBP cascade of stumps) first n_stages with their trees
    paired into 2-node trees: tree 2i's node is the root, whose left child
    is tree 2i+1's node and whose right is tree 2i's right leaf; the child's
    leaves are tree 2i+1's. The stage threshold is half the stage's, so
    that some windows pass each stage."""
    stage_cls, tree_cls = _classes(base)
    stages = []
    for st in base.stages[:n_stages]:
        trees = []
        for a, b in zip(st.trees[0::2], st.trees[1::2]):
            trees.append(tree_cls(
                left=np.array([1, -1], np.int32), right=np.array([0, -2], np.int32),
                feature_idx=np.array([a.feature_idx[0], b.feature_idx[0]], np.int32),
                subsets=np.stack([a.subsets[0], b.subsets[0]]).astype(np.int32),
                leaf_values=np.array([a.leaf_values[1], b.leaf_values[0], b.leaf_values[1]],
                                     np.float32),
            ))
        stages.append(stage_cls(threshold=st.threshold / 2, trees=trees))
    return dataclasses.replace(base, stages=stages, max_depth=2)


def truncated(model, n_stages: int):
    return dataclasses.replace(model, stages=list(model.stages[:n_stages]))


def policy_edge_cases():
    """(label, model, exacts) of every tile-kernel policy beyond the f32
    stump one: the cascades of ``knife_edge_model``, ``lbp_two_node_model``,
    the f64 stump cascades, Haar node trees upright (alt2) and tilted
    (eye_tree, 3 nodes, cut to 4 stages), and LBP stumps. Every policy runs
    in f32 and f64 on alt2 and the LBP frontal face; the tilted node trees
    and the 2-node LBP trees, which add no instantiation, in f64 only. The
    stage ranges to run come from ``policy_ranges``."""
    def xml(name):
        return read_cascade_xml(os.path.join(DATA, name))

    frontal = xml("haarcascade_frontalface_alt.xml")
    lbp = xml("lbpcascade_frontalface.xml")
    return [
        ("stump f64, frontal face", frontal, (True,)),
        ("stump f64, upper body (tilted)", xml("haarcascade_upperbody.xml"), (True,)),
        ("knife edge (stumps)", knife_edge_model(frontal), (False, True)),
        ("node, alt2", xml("haarcascade_frontalface_alt2.xml"), (False, True)),
        ("node, eye_tree cut to 4 stages (tilted, 3 nodes)",
         truncated(xml("haarcascade_eye_tree_eyeglasses.xml"), 4), (True,)),
        ("lbp, frontal face", lbp, (False, True)),
        ("lbp 2-node trees", lbp_two_node_model(lbp), (True,)),
    ]


def policy_ranges(n_stages: int, use_stage: bool):
    """Stage ranges for a cascade of n_stages: every stage, the first,
    all but the first and a middle chunk (stage kernel); or the front's
    ranges clipped to the cascade (every stage for a one-stage cascade)."""
    if n_stages == 1:
        return ((0, 1),)
    if use_stage:
        cand = ((0, n_stages), (0, 1), (1, n_stages), (min(5, n_stages), min(9, n_stages)))
    else:
        cand = tuple((min(a, n_stages), min(b, n_stages)) for a, b in FRONT_RANGES)
    return tuple(dict.fromkeys(cand))


def block_lists(alive) -> dict:
    """name → (blk, nblk) for a mask: the live blocks as the engine lists
    them; every block; every block with nblk one short; nblk 0; entries
    outside the block grid ahead of every block; every block in reverse
    order."""
    dev = alive.device
    every, _ = live_block_list(torch.ones_like(alive))
    nb = every.shape[0]
    nbr, nbc = block_grid(*alive.shape)
    stray = torch.tensor([[nbr, 0], [0, nbc], [-1, 0], [0, -1]], dtype=torch.int32, device=dev)

    def count(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    return {
        "live blocks": live_block_list(alive),
        "every block": (every, count(nb)),
        "cut short": (every, count(nb - 1)),
        "nblk 0": (every, count(0)),
        "stray entries": (torch.cat([stray, every]), count(nb + len(stray))),
        "reverse order": (every.flip(0).contiguous(), count(nb)),
    }


def packed_edge_mismatches(cascade, device, exact: bool = False):
    """packed_front over every shape x mask x block list x stage range
    against its twin, and against ``front`` where every block is listed
    → (cases run, survivors summed, descriptions of the cases that
    differ). exact: f64 stage sums."""
    n, survivors, bad = 0, 0, []
    for k, (out_h, out_w) in enumerate(PACKED_SHAPES):
        sum2d, _, inv_nf = edge_inputs(k, out_h, out_w, cascade, device, False)
        for name, alive in edge_masks(out_h, out_w, device).items():
            for lname, (blk, nblk) in block_lists(alive).items():
                for s0, s1 in PACKED_RANGES:
                    args = (sum2d, inv_nf, alive, blk, nblk, cascade, s0, s1)
                    got = packed_front(*args, exact=exact)
                    same = torch.equal(got, packed_front(*args, impl="ref", exact=exact))
                    if lname in ("every block", "reverse order", "stray entries"):
                        same = same and torch.equal(
                            got, front(sum2d, inv_nf, alive, cascade, s0, s1, exact=exact))
                    n += 1
                    survivors += int(got.sum())
                    if not same:
                        bad.append(f"{out_h}x{out_w} windows, {name}, {lname}, "
                                   f"stages [{s0}, {s1})")
    return n, survivors, bad


def tilted_edge_cases():
    """(px (rows, w) int32 numpy, is_top, pad) per width and pad. The
    pixels are random everywhere, block tops and column 0 included: the
    kernel and the twin both skip those cells."""
    is_top = np.zeros(sum(TILTED_RUNS), bool)
    is_top[np.cumsum(TILTED_RUNS)[:-1]] = True
    for i, w in enumerate(TILTED_WIDTHS):
        px = np.random.default_rng(100 + i).integers(0, 256, (len(is_top), w)).astype(np.int32)
        for pad in TILTED_PADS:
            yield px, is_top, pad


def tilted_edge_mismatches(device):
    """tilted over tilted_edge_cases() against its twin → (cases run,
    descriptions of the cases that differ)."""
    n, bad = 0, []
    for px, is_top, pad in tilted_edge_cases():
        pxd = torch.from_numpy(px).to(device)
        n += 1
        if not torch.equal(tilted(pxd, is_top, pad), tilted(pxd, is_top, pad, impl="ref")):
            bad.append(f"{px.shape[1]} columns, pad {pad}")
    return n, bad


def integral_edge_cases():
    """px (h, w) numpy per height x width x type: uint8 over [0, 256),
    then int32 over [0, 2^20)."""
    for i, (h, w) in enumerate(itertools.product(INTEGRAL_HEIGHTS, INTEGRAL_WIDTHS)):
        rng = np.random.default_rng(200 + i)
        yield rng.integers(0, 256, (h, w)).astype(np.uint8)
        yield rng.integers(0, 1 << 20, (h, w)).astype(np.int32)


def integral_edge_mismatches(device):
    """integral over integral_edge_cases() against its twin → (cases run,
    descriptions of the cases that differ)."""
    n, bad = 0, []
    for px in integral_edge_cases():
        pxd = torch.from_numpy(px).to(device)
        got, want = integral(pxd), integral(pxd, impl="ref")
        n += 1
        if not all(torch.equal(g, r) for g, r in zip(got, want)):
            bad.append(f"{px.shape[0]}x{px.shape[1]} {px.dtype}")
    return n, bad


def skewed_codes(rng, b: int, n: int) -> np.ndarray:
    """(b, n) int32 LBP-like codes: about 60 % of each feature's samples
    on 3 codes of its own (the uniform patterns real codes bunch on), the
    rest spread over all 256."""
    hot = rng.integers(0, 256, (b, 3))
    bunched = np.take_along_axis(hot, rng.integers(0, 3, (b, n)), 1)
    return np.where(rng.random((b, n)) < 0.6, bunched,
                    rng.integers(0, 256, (b, n))).astype(np.int32)


def _cat_tables(rng, n: int):
    w = rng.random(n) ** 3
    return w / w.sum(), rng.choice([-1.0, 1.0], n), rng.random(n) > 0.1


def cat_split_edge_cases(wave: int):
    """(label, codes (b, n) int32, w, resp, mask) numpy per case; wave: the
    features one launch at CAT_TRAIN_N samples works on at once."""
    for n in CAT_NS:
        rng = np.random.default_rng(300 + n)
        codes = np.stack([rng.integers(0, 256, n), rng.integers(0, 4, n), np.full(n, 77),
                          skewed_codes(rng, 1, n)[0]]).astype(np.int32)
        padded = -(-n // 32) * 32
        lo0 = (padded - n) // 2 if n > 32 else 0
        win = min(1, padded // 32 - 1)  # a window of one code in a uniform feature
        codes[0, max(0, 32 * win - lo0):32 * win - lo0 + 32] = 200
        yield f"n {n}", codes, *_cat_tables(rng, n)
    for b in (wave - 1, wave, wave + 1):
        rng = np.random.default_rng(400 + b)
        yield (f"{b} features (a wave is {wave})", skewed_codes(rng, b, CAT_TRAIN_N),
               *_cat_tables(rng, CAT_TRAIN_N))


def cat_split_edge_mismatches(device):
    """cat_split's kernel over cat_split_edge_cases() in its three policies
    against the plain version on the same device → (cases run,
    descriptions of the cases that differ)."""
    with torch.cuda.device(device):
        wave = wave_features(CAT_TRAIN_N)
    n, bad = 0, []
    for label, codes, w, resp, mask in cat_split_edge_cases(wave):
        c = torch.from_numpy(codes).to(device)
        wm = torch.from_numpy(np.where(mask, w, 0.0)).to(device)
        cls = torch.from_numpy(resp > 0).to(device)
        reg = (wm, wm * torch.from_numpy(resp).to(device))
        two = (torch.where(cls, 0.0, wm), torch.where(cls, wm, 0.0))
        for policy, run in (
                ("regression", lambda **kw: categorical_split(c, *reg, **kw)),
                ("misclassification", lambda **kw: categorical_class_split(c, *two, False, **kw)),
                ("Gini", lambda **kw: categorical_class_split(c, *two, True, **kw))):
            got, want = run(), run(impl="ref")
            n += 1
            if not all(torch.equal(g, r) for g, r in zip(got, want)):
                bad.append(f"{label}, {policy}")
    return n, bad


# sample counts of the two-class split kernel (csrc/split_class.cu): one
# block of 16 and around it, around a chunk of 256 and around the third
# level of the scan (4 096)
CLASS_NS = (1, 15, 16, 17, 255, 256, 257, 4096, 4097)


def _class_block(rng, b: int, n: int):
    """(b, n) f32 values with ties and neighbours within 2·FLT_EPSILON, and
    cubed random weights (sum 1), classes and a 20 % mask."""
    v = rng.integers(0, 40, (b, n)).astype(np.float32) * np.float32(0.37)
    v[:, ::7] += np.float32(1e-7)
    w = rng.random(n) ** 3
    return v, w / w.sum(), rng.random(n) > 0.5, rng.random(n) > 0.2


def class_split_edge_cases(shared_max: int):
    """(label, values (b, n) f32, w (n,) f64, cls (n,) bool, mask (n,) bool)
    numpy per case; shared_max: the largest sample count whose table the
    kernel keeps in shared memory (split.class_shared_max())."""
    for n in CLASS_NS:
        yield (f"n {n}", *_class_block(np.random.default_rng(500 + n), 3, n))
    for b in (1, 33):  # one feature; an odd count, a warp's pair half used
        yield (f"{b} features", *_class_block(np.random.default_rng(600 + b), b, 300))
    for n in (shared_max, shared_max + 1):  # the table in shared, then global memory
        yield (f"n {n} (tables in shared memory up to {shared_max})",
               *_class_block(np.random.default_rng(700), 3, n))
    rng = np.random.default_rng(800)
    v, w, cls, mask = _class_block(rng, 5, 300)
    yield "every sample masked out", v, w, cls, np.zeros(300, bool)
    yield "class 0 only", v, w, np.zeros(300, bool), mask
    yield "class 1 only", v, w, np.ones(300, bool), mask
    yield "every value equal", np.full((5, 300), 0.37, np.float32), w, cls, mask
    zeros = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0], np.float32), (5, 300))
    zeros[1] = rng.choice(np.array([-0.0, 0.0], np.float32), 300)  # no valid split
    yield "values of -1, -0.0, +0.0 and 1", zeros, w, cls, mask
    # samples in value order, chunk 1 masked out: chunk 0's last kept
    # position is judged against chunk 2's first kept value
    order_v = np.tile(np.arange(800, dtype=np.float32) * np.float32(0.25), (3, 1))
    order_v[1] += np.float32(1.0)
    gap = rng.random(800) > 0.2
    gap[256:512] = False
    yield "a fully masked chunk between kept positions", order_v, \
        np.ones(800) / 800, np.arange(800) % 3 == 0, gap
    # dyadic weights: class 1 first, a span of zero weight over a chunk's
    # edge, then class 0: every position of the span ties exactly
    tw = np.random.default_rng(900).integers(1, 64, 600) / 1024.0
    tw[240:300] = 0.0
    yield ("exact ties across blocks and a chunk's edge", order_v[:, :600].copy(), tw,
           np.arange(600) < 240, np.ones(600, bool))


def class_split_inputs(v, w, cls, mask, device, layout: str):
    """The two-class split's arguments for one edge case on device: the
    sorted values and the sort order ("fresh": torch.sort's (B, N) outputs
    seen transposed; "resident": contiguous (N, B)), the class weights, the
    mask and their totals."""
    from cascadeclassifier_tpu_torch.train.split import tree_sum

    si = np.argsort(v, axis=1, kind="stable")
    vs = torch.from_numpy(np.take_along_axis(v, si, 1)).to(device)
    order = torch.from_numpy(si).to(device)
    vs, order = (vs.t(), order.t()) if layout == "fresh" else (vs.t().contiguous(),
                                                               order.t().contiguous())
    wm = np.where(mask, w, 0.0)
    w0, w1 = np.where(cls, 0.0, wm), np.where(cls, wm, 0.0)
    t0 = tree_sum(w0)
    tabs = [torch.from_numpy(x).to(device) for x in (w0, w1, mask)]
    return vs, order, *tabs, t0, tree_sum(wm) - t0


def class_split_edge_mismatches(device):
    """split_scan_class_gather's kernel over class_split_edge_cases() in
    both policies and both layouts against the plain version on the CPU →
    (cases run, descriptions of the cases that differ)."""
    from cascadeclassifier_tpu_torch.train.split import class_shared_max, split_scan_class_gather

    with torch.cuda.device(device):
        shared_max = class_shared_max()
    n, bad = 0, []
    for label, v, w, cls, mask in class_split_edge_cases(shared_max):
        for layout in ("fresh", "resident"):
            args = class_split_inputs(v, w, cls, mask, device, layout)
            cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
            for gini in (False, True):
                got = split_scan_class_gather(*args, gini)
                want = split_scan_class_gather(*cpu, gini)
                n += 1
                if not all(torch.equal(g.cpu(), r) for g, r in zip(got, want)):
                    bad.append(f"{label}, {layout}, {'Gini' if gini else 'misclassification'}")
    return n, bad


# (h, w): around the runs of 16; 181 x 256 and 256 x 181 at the wrapper's
# limit (5hw bytes ≤ 227 KiB), one channel a CTA, the second with a padded stride
HOG_SIDES = ((24, 24), (32, 32), (16, 17), (33, 20), (181, 256), (256, 181))
HOG_ALL_VARS = 4096  # sides with more variables check every 97th and the last feature's


def _stencils(h: int, w: int, pairs) -> np.ndarray:
    """A zero window with one 3x3 stencil per (gx, gy) pair, 3 pixels
    apart (no two overlap): the stencil's centre has that gradient."""
    x = np.zeros((h, w), np.uint8)
    centres = [(y, c) for y in range(1, h - 1, 3) for c in range(1, w - 1, 3)]
    for (y, c), (gx, gy) in zip(centres, itertools.cycle(pairs)):
        a, b = max(0, -gx), max(0, -gy)
        x[y, c - 1], x[y, c + 1], x[y - 1, c], x[y + 1, c] = a, a + gx, b, b + gy
    return x


def hog_edge_cases(h: int, w: int):
    """(label, (k, h, w) uint8 windows) of the HOG kernels' edge cases."""
    flat = np.full((h, w), 128, np.uint8)
    vstep, hstep = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
    vstep[:, w // 2:] = 255
    hstep[h // 2:] = 255
    borders = np.zeros((4, h, w), np.uint8)
    borders[0, :, 0] = borders[1, :, -1] = borders[2, 0] = borders[3, -1] = 255
    yield "flat and step edges", np.stack([flat, vstep, hstep, 255 - vstep])
    yield "±255 at the borders", np.concatenate([borders, 255 - borders])
    rng = np.random.default_rng(h * 100 + w)
    yield "noise", rng.integers(0, 256, (8, h, w), dtype=np.uint8)
    for j in range(2 * N_BINS):
        ang = (j + 0.5) * np.pi / N_BINS
        pairs = [(int(np.rint(r * np.cos(ang))) + dx, int(np.rint(r * np.sin(ang))) + dy)
                 for r in (9, 120, 254) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        pairs = [(max(-255, min(255, gx)), max(-255, min(255, gy))) for gx, gy in pairs]
        yield f"bin edge {j}", _stencils(h, w, pairs)[None]
    for k in (1, 3, 5):
        yield f"{k} noise windows", rng.integers(0, 256, (k, h, w), dtype=np.uint8)


def hog_id_cases(var_count: int, seed: int):
    """(label, (K,) int64 variable ids) of hog_eval's lists."""
    rng = np.random.default_rng(seed)
    some = rng.integers(0, var_count, 40)
    yield "unsorted, repeated", np.concatenate([some, some[::3], some[:1]])
    many = rng.integers(0, var_count, 150)  # longer than hog_eval.cu's kDirectMax: the plan's path
    yield "unsorted, repeated, long", np.concatenate([many, many[::2]])
    yield "one variable", rng.integers(0, var_count, 1)
    yield "one feature's 36 shuffled", rng.integers(0, var_count // 36) * 36 + rng.permutation(36)


def hog_edge_mismatches(device):
    """hog_hist and hog_eval (every variable of the window's catalog, or a
    sample of at most HOG_ALL_VARS) over hog_edge_cases() at HOG_SIDES, and
    hog_eval over hog_id_cases() on each side's noise, against their plain
    versions on the same device → (cases run, descriptions of the cases
    that differ)."""
    n, bad = 0, []
    for h, w in HOG_SIDES:
        cat = hog_catalog(w, h)
        cells = torch.from_numpy(cat.cell_corner_offsets()).to(device)
        ids = torch.arange(cat.var_count, device=device)
        if cat.var_count > HOG_ALL_VARS:
            ids = torch.cat([ids[::97], ids[-36:]])
        noise = None
        for label, x in hog_edge_cases(h, w):
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            hist, norm = hog_integral_histogram(xd)
            want_h, want_n = hog_integral_histogram(xd, impl="ref")
            flat = (hist.reshape(len(x), N_BINS, -1), norm.reshape(len(x), -1))
            got = hog_responses(*flat, cells, ids)
            want = hog_responses(*flat, cells, ids, impl="ref")
            n += 1
            if not (torch.equal(hist, want_h) and torch.equal(norm, want_n)
                    and torch.equal(got, want)):
                bad.append(f"{h}x{w} {label}")
            if label == "noise":
                noise = flat
        for label, case in hog_id_cases(cat.var_count, h * w):
            case = torch.from_numpy(case).to(device)
            n += 1
            if not torch.equal(hog_responses(*noise, cells, case),
                               hog_responses(*noise, cells, case, impl="ref")):
                bad.append(f"{h}x{w} hog_eval {label}")
    return n, bad


# -- the dense miner (csrc/mine.cu) ------------------------------------------

# trees a case's stages hold: around a block of 16 and a level-1 block of
# 256 of the blocked scan, with stage ends on and beside the boundaries
MINE_STAGE_SIZES = ((1,), (15,), (16,), (1, 16), (17,), (5, 12), (3, 17, 20), (255, 2),
                    (256,), (100, 156), (16, 240, 45), (300,))


def grid_positions(dh: int, dw: int, ww: int, wh: int, oy: int = 0, ox: int = 0,
                   first: int = 0) -> np.ndarray:
    """(m, 2) int32 (px, py) of a mining level's schedule: the grid of
    stride (wh // 2, ww // 2) from (oy, ox) as far as windows fit (the last
    column and row reach the level's edge where the stride lands there),
    from column index first of its first row."""
    sy, sx = wh // 2, ww // 2
    nx, ny = (dw - ww - ox) // sx + 1, (dh - wh - oy) // sy + 1
    gx, gy = np.meshgrid(ox + sx * np.arange(nx), oy + sy * np.arange(ny))
    return np.stack([gx.ravel(), gy.ravel()], 1)[first:].astype(np.int32)


def mine_level_specs(seed: int, ww: int, wh: int):
    """Mining levels of every kind the miner takes, as plain specs
    (kind "lazy" or "eager", source or image, level (h, w), src_id,
    positions): a lazy level scaled up from a noise source with a flat
    patch (nf = 0 windows) from the third column of its first row; a lazy
    level at scale 1 whose last row and column reach its edge; an eager
    level; a level with one window; an empty level; a lazy level of a
    source 2 pixels wide."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (3 * wh, 4 * ww)).astype(np.uint8)
    src[wh // 2:wh // 2 + 2 * wh, ww:ww + 2 * ww] = 97  # flat: windows inside have nf = 0
    dh, dw = 3 * wh + wh // 2 + 3, 4 * ww + ww // 2 + 5
    src1 = rng.integers(0, 256, (2 * wh + wh // 2, 3 * ww + ww // 2)).astype(np.uint8)
    img = rng.integers(0, 256, (2 * wh + 4, 3 * ww + 1)).astype(np.uint8)
    src2 = rng.integers(0, 256, (wh + 3, 2)).astype(np.uint8)
    return [
        ("lazy", src, (dh, dw), 0, grid_positions(dh, dw, ww, wh, first=2)),
        ("lazy", src1, src1.shape, 1, grid_positions(*src1.shape, ww, wh)),
        ("eager", img, img.shape, None, grid_positions(*img.shape, ww, wh, oy=1, ox=1)),
        ("lazy", src, (wh + 1, ww), 0, grid_positions(wh + 1, ww, ww, wh)),
        ("eager", img, img.shape, None, np.zeros((0, 2), np.int32)),
        ("lazy", src2, (wh + wh // 2, ww + 3), 2, grid_positions(wh + wh // 2, ww + 3, ww, wh)),
    ]


def tile_level_specs(seed: int, ww: int, wh: int, kind: int):
    """Mining levels at the edges of the tile kernel's tiles
    (``train/mine.py::tile_shape`` for the kind), specs as
    mine_level_specs's: a run that starts and ends inside tiles (as a
    GridRun and as positions); a level narrower and shorter than one
    tile; a grid one window past a whole number of tiles each way, whose
    last tile holds one window; a grid of one column (nx = 1)."""
    from cascadeclassifier_tpu_torch.data.negreader import GridRun
    from cascadeclassifier_tpu_torch.train import mine

    tx, ty = mine.tile_shape(ww, wh, kind)
    sy, sx = wh // 2, ww // 2
    rng = np.random.default_rng(seed)

    def level(nx, ny, oy=0, ox=0):  # a level (h, w) just holding the grid, a source for it
        h, w = oy + sy * (ny - 1) + wh + 1, ox + sx * (nx - 1) + ww + 2
        return (h, w), rng.integers(0, 256, (h // 2 + 3, w // 2 + 5)).astype(np.uint8)

    nx, ny = tx + 3, 2 * ty + 1
    dims, src = level(nx, ny, 2, 1)
    mid = GridRun(1, 2, sx, sy, nx, tx // 2 + 1, nx * 2 * ty - 3)
    pos = np.asarray(grid_positions(*dims, ww, wh, oy=2, ox=1))[tx + 2:nx * ty + 1]
    small, small_src = level(max(1, tx - 3), max(1, ty - 1))
    small_img = rng.integers(0, 256, small).astype(np.uint8)
    one, one_src = level(tx + 1, ty + 1)
    col, col_src = level(1, ty + 2)
    return [
        ("lazy", src, dims, 10, mid),
        ("lazy", src, dims, 10, pos),
        ("eager", small_img, small, None,
         GridRun(0, 0, sx, sy, max(1, tx - 3), 0, max(1, tx - 3) * max(1, ty - 1))),
        ("lazy", one_src, one, 11, GridRun(0, 0, sx, sy, tx + 1, 0, (tx + 1) * (ty + 1))),
        ("lazy", col_src, col, 12, GridRun(0, 0, sx, sy, 1, 0, ty + 2)),
    ]


def levels_of(specs, lazy_cls) -> list:
    """The trainer's (img, positions, key) levels of mine_level_specs's
    specs, lazy levels as lazy_cls(src, src_id, w, h) (the port's
    LazyLevel, or the JAX package's)."""
    out = []
    for i, (kind, a, (h, w), src_id, pos) in enumerate(specs):
        img = lazy_cls(a, src_id, w, h) if kind == "lazy" else a
        out.append((img, pos, (i, kind)))
    return out


def stump_specs(values, ids, sizes, rng, categorical: bool, pass_rate: float = 0.75,
                neg_zero: bool = False, all_bits: bool = False, knife: bool = False) -> list:
    """Stages of stumps over the candidate features ids (global) whose
    values on a case's windows are values (len(ids), m) (Haar f32, LBP
    codes), as specs [{"features", "thr", "subsets", "leaves",
    "threshold"}]: each tree's threshold the value of one of the windows
    (values equal to thresholds), or 8 random subset words (all_bits:
    every third tree all ones); f32 leaves (neg_zero: every fourth
    -0.0); each stage's threshold the quantile of its survivors' sums
    (differences of scan_cumsum's prefix, as the walk takes them) that
    passes about pass_rate of them, and not all of them where their sums
    differ. knife: leaves of magnitudes 2^-40 to 2^30, whose f64 sums
    round apart in other orders, and each stage's threshold, where it
    can, on a survivor near that quantile that a running sum in tree
    order would judge the other way."""
    from cascadeclassifier_tpu_torch.train.split import scan_cumsum

    values = np.asarray(values)
    m = values.shape[1]
    alive = np.ones(m, bool)
    out, taken = [], []
    for n in sizes:
        pick = rng.integers(0, len(ids), n)
        feats = np.asarray(ids)[pick]
        v = values[pick]
        if categorical:
            subsets = rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32)
            if all_bits:
                subsets[::3] = -1
            bit = (subsets[np.arange(n)[:, None], v >> 5] >> (v & 31)) & 1
            left, thr = bit != 0, np.zeros(n, np.float32)
        else:
            thr = v[np.arange(n), rng.integers(0, m, n)].astype(np.float32)
            left, subsets = v <= thr[:, None], None
        if knife:
            leaves = (rng.choice([-1.0, 1.0], (n, 2))
                      * np.exp2(rng.uniform(-40, 30, (n, 2)))).astype(np.float32)
        else:
            leaves = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
        if neg_zero:
            leaves[::4] = np.float32(-0.0)
        taken.append(np.where(left, leaves[:, :1], leaves[:, 1:]).astype(np.float64))
        every = np.concatenate(taken)  # (trees so far, m)
        end = every.shape[0]

        def stage_sum(pref):
            return pref[end - 1] - (pref[end - n - 1] if end > n else 0.0)

        sums = stage_sum(scan_cumsum(torch.from_numpy(every)).numpy())
        live = np.sort(sums[alive]) if alive.any() else np.zeros(1)
        threshold = float(live[int((1.0 - pass_rate) * (len(live) - 1))])
        if threshold == live[0] and live[-1] > live[0]:  # reject some of them
            threshold = float(live[live > live[0]][0])
        if knife:
            other = stage_sum(np.cumsum(every, axis=0))
            cand = np.flatnonzero(alive & (sums != other))
            if len(cand):
                k = cand[np.argmin(np.abs(sums[cand] - threshold))]
                hi = max(sums[k], other[k])  # passes; the other order's sum fails
                t = hi + 1e-5
                for _ in range(8):
                    if t - 1e-5 == hi:
                        threshold = float(t)
                        break
                    t = np.nextafter(t, np.inf if t - 1e-5 < hi else -np.inf)
        alive &= ~(sums < threshold - 1e-5)
        out.append({"features": feats, "thr": thr, "subsets": subsets, "leaves": leaves,
                    "threshold": threshold})
    return out


def stages_of(specs, stage_cls, tree_cls) -> list:
    """stump_specs's stages as stage_cls(threshold, trees) of
    tree_cls(left, right, feature_idx, threshold, subsets, leaf_values)
    stumps (the port's model classes, or the JAX package's)."""
    stages = []
    for s in specs:
        trees = []
        for i in range(len(s["features"])):
            trees.append(tree_cls(
                left=np.array([0], np.int32), right=np.array([-1], np.int32),
                feature_idx=np.array([s["features"][i]], np.int32),
                threshold=None if s["subsets"] is not None else s["thr"][i:i + 1].copy(),
                subsets=None if s["subsets"] is None else s["subsets"][i:i + 1].copy(),
                leaf_values=s["leaves"][i].copy()))
        stages.append(stage_cls(threshold=s["threshold"], trees=trees))
    return stages


def tilted_edge_features(catalog) -> np.ndarray:
    """Global ids of the catalog's tilted features whose corners touch the
    window's edge (column 0, the last column or the last row)."""
    r = catalog.rects
    x, y, w, h = r[:, :, 0], r[:, :, 1], r[:, :, 2], r[:, :, 3]
    used = catalog.weights != 0
    touch = used & ((x - h == 0) | (x + w == catalog.win_w) | (y + w + h == catalog.win_h))
    return np.flatnonzero(catalog.tilted & touch.any(axis=1))


def mine_candidates(feature: str, ww: int, wh: int, rng, n: int = 48) -> np.ndarray:
    """n candidate feature ids of a case (Haar ALL: half of them tilted
    features touching the window's edge)."""
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog, lbp_catalog

    if feature == "LBP":
        return rng.choice(len(lbp_catalog(ww, wh)), n, replace=False)
    cat = haar_catalog(ww, wh, feature)
    ids = rng.choice(len(cat), n, replace=False)
    if feature == "ALL":
        edge = tilted_edge_features(cat)
        ids[: n // 2] = rng.choice(edge, n // 2, replace=False)
    return np.unique(ids)


def mine_evaluator(feature: str, ww: int, wh: int, device):
    """The port's training evaluator of a case: Haar in the mode feature, or LBP."""
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog, lbp_catalog
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator, LBPTrainEvaluator

    if feature == "LBP":
        return LBPTrainEvaluator(lbp_catalog(ww, wh), device=device)
    return HaarTrainEvaluator(haar_catalog(ww, wh, feature), device=device)


def mine_case(feature: str, ww: int, wh: int, sizes, seed: int, tiles: bool = False, **opts):
    """One miner case on the CPU: (levels with the port's LazyLevel, the
    port's stages from stump_specs over mine_level_specs's windows, the
    specs themselves); tiles: tile_level_specs's levels after those."""
    from cascadeclassifier_tpu_torch.data.negreader import LazyLevel
    from cascadeclassifier_tpu_torch.models.model import Stage, WeakTree
    from cascadeclassifier_tpu_torch.train import mine

    rng = np.random.default_rng(seed)
    specs = mine_level_specs(seed, ww, wh)
    if tiles:
        kind = {"LBP": mine.KIND_LBP, "ALL": mine.KIND_HAAR_TILTED}.get(feature, mine.KIND_HAAR)
        specs += tile_level_specs(seed + 1, ww, wh, kind)
    levels = levels_of(specs, LazyLevel)
    ids = mine_candidates(feature, ww, wh, rng)
    ev = mine_evaluator(feature, ww, wh, "cpu")
    ev.set_samples(mine.level_windows(mine.pack_levels(levels, ww, wh, "cpu"), ww, wh))
    values = ev.values_for_vars(ids).numpy()
    specs = stump_specs(values, ids, sizes, rng, feature == "LBP", **opts)
    return levels, stages_of(specs, Stage, WeakTree), specs


def mine_edge_cases():
    """(label, feature, ww, wh, levels, stages) of the miner's edges, on
    the CPU: every stage set of MINE_STAGE_SIZES over Haar BASIC at 12x12
    (past 17 trees with stump_specs's knife-edge thresholds, where the
    prefix's order decides a window);
    -0.0 leaves; Haar ALL at 24x24 with tilted features touching the
    window's edge; LBP at 12x12 and 24x24 with all-bits subsets (flat
    windows give code 255); each on mine_level_specs's levels (nf = 0
    windows, the last row and column, a scale-1 lazy level, a source 2
    pixels wide, eager levels, one window, an empty level); then the tile
    kernel's edges, on tile_level_specs's levels beside those: Haar BASIC
    at 12x12 and 24x24 (runs starting and ending inside tiles, a level
    inside one tile, a one-window last tile, nx = 1), a 13x11 window (odd,
    sx != sy), Haar ALL at 24x24 with tilted features touching the window's
    edge on every tile border, LBP at 24x24."""
    for i, sizes in enumerate(MINE_STAGE_SIZES):
        yield (f"BASIC 12x12, stages of {sizes} trees", "BASIC", 12, 12,
               *mine_case("BASIC", 12, 12, sizes, 1000 + i, knife=sum(sizes) > 17)[:2])
    yield ("BASIC 24x24, -0.0 leaves", "BASIC", 24, 24,
           *mine_case("BASIC", 24, 24, (7, 30), 1100, neg_zero=True)[:2])
    for sizes in ((9,), (16, 240, 45)):
        yield (f"ALL 24x24, tilted at the window's edge, stages of {sizes} trees", "ALL", 24,
               24, *mine_case("ALL", 24, 24, sizes, 1200 + len(sizes),
                              knife=sum(sizes) > 17)[:2])
    for side, sizes in ((12, (3, 17)), (24, (16, 240, 45))):
        yield (f"LBP {side}x{side}, all-bits subsets, stages of {sizes} trees", "LBP", side,
               side, *mine_case("LBP", side, side, sizes, 1300 + side, all_bits=True,
                                knife=sum(sizes) > 17)[:2])
    for feature, ww, wh, sizes, label in (
            ("BASIC", 12, 12, (3, 17, 20), "tile edges"),
            ("BASIC", 24, 24, (2, 2, 4, 40), "tile edges"),
            ("BASIC", 13, 11, (5, 12), "an odd window (sx != sy), tile edges"),
            ("ALL", 24, 24, (9, 16, 40), "tilted features at the window's edge on tile borders"),
            ("LBP", 24, 24, (3, 17), "tile edges")):
        yield (f"{feature} {ww}x{wh}, {label}, stages of {sizes} trees", feature, ww, wh,
               *mine_case(feature, ww, wh, sizes, 1400 + ww + wh + len(sizes), tiles=True,
                          knife=sum(sizes) > 17, pass_rate=0.6)[:2])


def mine_inputs(feature: str, ww: int, wh: int, levels, stages, device):
    """mine's arguments for a case on device."""
    from cascadeclassifier_tpu_torch.train import mine

    ev = mine_evaluator(feature, ww, wh, device)
    used = sorted({int(t.feature_idx[0]) for s in stages for t in s.trees})
    return (mine.pack_levels(levels, ww, wh, device), mine.features_of(ev, used),
            mine.tree_table(stages, used, feature == "LBP", device))


def mine_edge_mismatches(device, run=None):
    """The miner's kernel (run: ``mine.mine``, or ``mine.mine_warp``) over
    mine_edge_cases() against its plain version on the same inputs on
    device → (cases run, windows, descriptions of the cases that
    differ)."""
    from cascadeclassifier_tpu_torch.train import mine

    run = mine.mine if run is None else run
    n, windows, bad = 0, 0, []
    for label, feature, ww, wh, levels, stages in mine_edge_cases():
        args = mine_inputs(feature, ww, wh, levels, stages, device)
        got = run(*args, ww, wh)
        want = mine.mine(*args, ww, wh, impl="ref")
        n += 1
        windows += got.numel()
        if not torch.equal(got, want):
            bad.append(f"{label}: {int((got != want).sum())} of {got.numel()} windows differ")
    return n, windows, bad
