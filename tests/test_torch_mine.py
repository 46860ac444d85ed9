"""The dense miner (train/mine.py, csrc/mine.cu) against the JAX package's
dense mining program on the CPU.

- ``mine_ref`` and the port's ``predict_levels`` built on it give the
  masks of the JAX package's ``CascadePredictor.predict_levels``
  (``_dense_chunk_fn``) on lazy and eager levels, partial first rows, a
  level of one window and an empty one, for Haar BASIC at 12x12 and
  24x24, Haar ALL with tilted features and LBP, with stage sets of 1 to
  300 trees (stages_from_jax of JAX stages).
- ``_mine_kernel_in_numpy`` replays ``csrc/mine.cu`` step for step (the
  pixels from the axis tables, the integral a column sum and a warp scan
  at a time, the tilted recurrence, the norm factor, the features, the
  streaming blocked prefix and the early exit) and gives the same masks
  on the same cases and on utils/edges.py's miner edges; its streaming
  prefix equals ``scan_cumsum`` bit for bit past every block boundary.
- ``pack_levels`` covers exactly the positions it was given, in order,
  and its source arena starts over past its cap; ``check_exact`` fires
  beyond 2^24, in the kernel's wrapper only.
- ``_tile_kernel_in_numpy`` replays the tile kernel (``tile_kernel``, the
  miner's path): the CTA schedule over the rows' first tiles, a tile's
  pixels built once, its uint32 integrals (noise where the tile leaves
  them unbuilt), the windows' values by corners at their tile offsets,
  a thread a window through the short stages with its own walk, the
  survivors handed to warps; it gives the JAX package's masks on the
  same cases and mine_ref's on every edge at three hand-off thresholds,
  writing each window once. The tile's tilted corners equal
  ``integral_tilted``'s window-local ones for every tilted feature at
  windows on each of a tile's edges; the schedule covers every window
  of every run once; a thread's walk equals ``scan_cumsum``; the tile
  layout mirrors the source's constants.
- ``pack_levels`` takes a reader's ``GridRun`` levels without building
  their positions and gives the table their arrays give.
- ``tests/test_torch_mine_cuda.py`` holds ``mine`` against ``mine_ref``
  on the card.

Masks are compared for equality.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.data.negreader import LazyLevel as JLazyLevel  # noqa: E402
from cascadeclassifier_tpu.models.model import Stage as JStage  # noqa: E402
from cascadeclassifier_tpu.models.model import WeakTree as JWeakTree  # noqa: E402
from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    LBPTrainEvaluator as JLBPTrainEvaluator,
)
from cascadeclassifier_tpu.train.predictor import CascadePredictor as JPredictor  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.convert import stages_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.data.negreader import GridRun, LazyLevel, NegReader  # noqa: E402
from cascadeclassifier_tpu_torch.ops.integral import integral_tilted  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import haar_catalog, sum_offsets  # noqa: E402
from cascadeclassifier_tpu_torch.train import mine  # noqa: E402
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402
from cascadeclassifier_tpu_torch.train.split import scan_cumsum  # noqa: E402
from cascadeclassifier_tpu_torch.utils import edges, time_mine, train_data  # noqa: E402

LEVELS = 3  # csrc/mine.cu's kLevels
EPS = 1e-5
N_EDGES = 22  # utils/edges.py::mine_edge_cases


# -- a numpy replay of csrc/mine.cu ------------------------------------------


def _axis_tab_c(ssz: int, dsz: int, d):
    """mine.cu's axis_tab over the coordinates d (int64): C's truncating
    division corrected to a floor, as the kernel does."""
    two = 2 * dsz
    num = (2 * d + 1) * ssz - dsz
    qt = np.sign(num) * (np.abs(num) // two)
    sx = np.where((num - qt * two != 0) & (num < 0), qt - 1, qt)
    a = 128 * (num - sx * two)
    q = a // dsz
    r = a - q * dsz
    c = q + ((2 * r > dsz) | ((2 * r == dsz) & (q % 2 == 1)))
    c = np.where(sx < 0, 0, c)
    sx = np.where(sx < 0, 0, sx)
    hi = sx >= ssz - 1
    sx = np.where(hi, ssz - 2 if ssz > 1 else 0, sx)
    c = np.where(hi, 256 if ssz > 1 else 0, c)
    oob = d >= dsz
    sx, c = np.where(oob, 0, sx), np.where(oob, 0, c)
    return sx, np.minimum(sx + 1, ssz - 1), c


def _pixels_in_numpy(levels, ww, wh):
    """(n, wh, ww) int64: each window's pixels as the kernel builds them."""
    table = levels.table.numpy()
    lazy, eager = levels.lazy.numpy(), levels.eager.numpy()
    sy, sx = wh // 2, ww // 2
    out = []
    for row in table:
        k = np.arange(row[mine.COUNT])
        q = row[mine.W0] + k
        y0 = row[mine.OY] + (q // row[mine.NX]) * sy
        x0 = row[mine.OX] + (q % row[mine.NX]) * sx
        ys = y0[:, None] + np.arange(wh)  # (m, wh)
        xs = x0[:, None] + np.arange(ww)  # (m, ww)
        sh, sw, dh, dw = row[mine.SH], row[mine.SW], row[mine.DH], row[mine.DW]
        if row[mine.EAGER]:
            img = eager[row[mine.SRC_OFF]:row[mine.SRC_OFF] + sh * sw].reshape(sh, sw)
            out.append(img[ys[:, :, None], xs[:, None, :]].astype(np.int64))
            continue
        src = lazy[row[mine.SRC_OFF]:row[mine.SRC_OFF] + sh * sw].reshape(sh, sw).astype(np.int64)
        ry0, ry1, cy = _axis_tab_c(sh, dh, ys)
        cx0, cx1, cx = _axis_tab_c(sw, dw, xs)
        g = lambda r, c: src[r[:, :, None], c[:, None, :]]  # noqa: E731
        cyb = cy[:, :, None]
        v0 = (256 - cyb) * g(ry0, cx0) + cyb * g(ry1, cx0)
        v1 = (256 - cyb) * g(ry0, cx1) + cyb * g(ry1, cx1)
        h = (256 - cx[:, None, :]) * v0 + cx[:, None, :] * v1
        v = np.minimum((h + (1 << 15)) >> 16, 255)
        inside = (ys[:, :, None] < dh) & (xs[:, None, :] < dw)
        out.append(np.where(inside, v, 0))
    return np.concatenate(out)


def _integral_in_numpy(pix):
    """The kernel's sum integral: chunks of 32 columns, a column sum down
    the rows a lane, scanned across the lanes, plus the last value of the
    previous chunk in the same row."""
    m, wh, ww = pix.shape
    s = np.zeros((m, wh + 1, ww + 1), np.int64)
    for cb in range(0, ww, 32):
        c = cb + np.arange(32)
        ok = c < ww
        col = np.zeros((m, 32), np.int64)
        for r in range(wh):
            col[:, ok] += pix[:, r, c[ok]]
            incl = np.cumsum(col, axis=1)
            carry = s[:, r + 1, cb] if cb else 0
            s[:, r + 1, c[ok] + 1] = (incl + (carry[:, None] if cb else 0))[:, ok]
    return s


def _tilted_in_numpy(pix):
    """The kernel's tilted integral: the row recurrence over rows padded
    with wh + 1 zero columns each side, three rolling rows."""
    m, wh, ww = pix.shape
    p = wh + 1
    pw = ww + 2 * p
    x = np.arange(pw + 1)
    xc = x - 1 - p
    inb = (xc >= 0) & (xc < ww)
    tm2 = np.zeros((m, pw + 1), np.int64)
    tm1 = np.zeros((m, pw + 1), np.int64)
    t = np.zeros((m, wh + 1, ww + 1), np.int64)
    for y in range(wh):
        r1 = np.where(inb, pix[:, y, np.clip(xc, 0, ww - 1)], 0)
        r0 = np.where(inb, pix[:, y - 1, np.clip(xc, 0, ww - 1)], 0) if y > 0 else 0
        left = np.concatenate([np.zeros((m, 1), np.int64), tm1[:, :-1]], axis=1)
        right = np.concatenate([tm1[:, 1:], np.zeros((m, 1), np.int64)], axis=1)
        tn = left + right - tm2 + r1 + r0
        t[:, y + 1] = tn[:, p:p + ww + 1]
        tm2, tm1 = tm1, tn
    return t


def _stream_prefix(leaves):
    """(m, T) f64 leaves → (m, T) prefixes as the kernel carries them: 32
    trees a step, each lane's sequential sum in its block of 16 from 0.0,
    plus its block's exclusive prefix; a completed block's total moves up
    LEVELS carried levels (an accumulator and an exclusive prefix each)."""
    m, n_t = leaves.shape
    acc = [np.zeros(m) for _ in range(LEVELS + 1)]
    ex = [np.zeros(m) for _ in range(LEVELS + 2)]
    cnt = [0] * (LEVELS + 1)

    def push(x):
        for lv in range(1, LEVELS + 1):
            acc[lv] = acc[lv] + x
            ex[lv] = acc[lv] + ex[lv + 1]
            cnt[lv] += 1
            if cnt[lv] < 16:
                break
            x, acc[lv], cnt[lv] = acc[lv], np.zeros(m), 0

    pref = np.zeros((m, n_t))
    for t0 in range(0, n_t, 32):
        x = np.zeros((m, 32))
        x[:, :min(32, n_t - t0)] = leaves[:, t0:t0 + 32]
        s = np.zeros((m, 32))
        for lane in range(32):
            a = np.zeros(m)
            for k in range(16):
                if k <= lane & 15:
                    a = a + x[:, (lane & 16) + k]
            s[:, lane] = a
        ex_a = ex[1]
        push(s[:, 15])
        ex_b = ex[1]
        push(s[:, 31])
        step = s + np.where(np.arange(32) < 16, ex_a[:, None], ex_b[:, None])
        pref[:, t0:t0 + 32] = step[:, :min(32, n_t - t0)]
    return pref


def _mine_kernel_in_numpy(levels, feats, trees, ww, wh):
    """csrc/mine.cu in numpy, every window at once → (n,) uint8."""
    if levels.n == 0:
        return np.zeros(0, np.uint8)
    pix = _pixels_in_numpy(levels, ww, wh)
    s = _integral_in_numpy(pix).reshape(len(pix), -1)
    ti = trees.feature.numpy()
    if feats.points is not None:
        pts = feats.points.numpy()[ti]  # (T, 16)
        gp = s[:, pts]  # (m, T, 16)
        cs = [gp[..., r * 4 + c] - gp[..., r * 4 + c + 1] - gp[..., (r + 1) * 4 + c]
              + gp[..., (r + 1) * 4 + c + 1] for r in range(3) for c in range(3)]
        code = sum((cs[i] >= cs[4]).astype(np.int64) << b
                   for i, b in ((0, 7), (1, 6), (2, 5), (5, 4), (8, 3), (7, 2), (6, 1), (3, 0)))
        words = trees.subsets.numpy().view(np.uint32)
        left = ((words[np.arange(len(ti)), code >> 5] >> (code & 31)) & 1) != 0
    else:
        tilted = _tilted_in_numpy(pix).reshape(len(pix), -1) if feats.has_tilted else s
        rh, rw, w1 = wh - 2, ww - 2, ww + 1
        inner = pix[:, 1:wh - 1, 1:ww - 1]
        sq = (inner * inner).sum(axis=(1, 2))
        lo = (1 + rh) * w1
        tot = s[:, w1 + 1] - s[:, w1 + 1 + rw] - s[:, lo + 1] + s[:, lo + 1 + rw]
        nf = np.sqrt(np.maximum(rh * rw * sq - tot * tot, 0).astype(np.float64)).astype(np.float32)
        off, w = feats.offsets.numpy()[ti], feats.weights.numpy()[ti]
        til = feats.tilted.numpy()[ti].astype(bool)
        raw = np.zeros((len(pix), len(ti)), np.int64)
        for r in range(3):
            o = off[:, r]
            def rect(img):
                return img[:, o[:, 0]] - img[:, o[:, 1]] - img[:, o[:, 2]] + img[:, o[:, 3]]

            raw += w[:, r] * np.where(til, rect(tilted), rect(s))
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.where(nf[:, None] != 0, raw.astype(np.float32) / nf[:, None], np.float32(0))
        left = v <= trees.thr.numpy()
    leaves = np.where(left, trees.left.numpy(), trees.right.numpy()).astype(np.float64)
    pref = _stream_prefix(leaves)
    alive = np.ones(len(pix), bool)
    start = np.zeros(len(pix))
    for end, thr in zip(trees.stage_end.numpy(), trees.stage_thr.numpy()):
        pe = pref[:, end - 1]
        alive &= ~(pe - start < thr - EPS)
        start = pe
    return alive.astype(np.uint8)


# -- a numpy replay of csrc/mine.cu's tile kernel -------------------------------


class _Walk:
    """mine.cu's Walk over a vector of windows: the blocked f64 prefix
    carried a leaf at a time (every window of a tile at the same tree, so
    the block counts are shared)."""

    def __init__(self, m):
        self.acc = [np.zeros(m) for _ in range(LEVELS + 1)]
        self.ex = [np.zeros(m) for _ in range(LEVELS + 2)]
        self.n = [0] * (LEVELS + 1)
        self.s = np.zeros(m)
        self.pos = 0

    def take(self, keep):
        """The states of the windows keep."""
        w = _Walk(int(keep.sum()))
        w.acc = [a[keep] for a in self.acc]
        w.ex = [e[keep] for e in self.ex]
        w.n, w.s, w.pos = list(self.n), self.s[keep], self.pos
        return w

    def _push(self, x):
        for lv in range(1, LEVELS + 1):
            self.acc[lv] = self.acc[lv] + x
            self.ex[lv] = self.acc[lv] + self.ex[lv + 1]
            self.n[lv] += 1
            if self.n[lv] < 16:
                break
            x, self.acc[lv], self.n[lv] = self.acc[lv], np.zeros_like(x), 0

    def add(self, x):
        self.s = self.s + x
        p = self.s + self.ex[1]
        self.pos += 1
        if self.pos == 16:
            self._push(self.s)
            self.s, self.pos = np.zeros_like(self.s), 0
        return p


def _walk_prefix(leaves):
    """(m, T) f64 leaves → (m, T) prefixes as a thread carries them."""
    w = _Walk(leaves.shape[0])
    return np.stack([w.add(leaves[:, t]) for t in range(leaves.shape[1])], 1) if (
        leaves.shape[1]) else np.zeros(leaves.shape)


def _tile_off(o, ww, pitch):
    """mine.cu's tile_off: the row by a multiply-high with ceil(2^32 / w1)."""
    w1 = ww + 1
    magic = 0xFFFFFFFF // w1 + 1
    r = (np.asarray(o, np.uint64) * np.uint64(magic)) >> np.uint64(32)
    r = r.astype(np.int64)
    return r * pitch + (np.asarray(o, np.int64) - r * w1)


def _tile_pixels(row, lazy, eager, y0, x0, phe, pwe):
    """(phe, pwe) int64: a tile's pixels as the kernel builds them."""
    sh, sw, dh, dw = row[mine.SH], row[mine.SW], row[mine.DH], row[mine.DW]
    ys, xs = y0 + np.arange(phe), x0 + np.arange(pwe)
    if row[mine.EAGER]:
        img = eager[row[mine.SRC_OFF]:row[mine.SRC_OFF] + sh * sw].reshape(sh, sw)
        return img[ys[:, None], xs[None, :]].astype(np.int64)
    src = lazy[row[mine.SRC_OFF]:row[mine.SRC_OFF] + sh * sw].reshape(sh, sw).astype(np.int64)
    ry0, ry1, cy = _axis_tab_c(sh, dh, ys)
    cx0, cx1, cx = _axis_tab_c(sw, dw, xs)
    cyb = cy[:, None]
    v0 = (256 - cyb) * src[ry0[:, None], cx0[None, :]] + cyb * src[ry1[:, None], cx0[None, :]]
    v1 = (256 - cyb) * src[ry0[:, None], cx1[None, :]] + cyb * src[ry1[:, None], cx1[None, :]]
    v = np.minimum(((256 - cx[None, :]) * v0 + cx[None, :] * v1 + (1 << 15)) >> 16, 255)
    return np.where((ys[:, None] < dh) & (xs[None, :] < dw), v, 0)


def _tile_integral(x, rows, pitch, rng):
    """(rows + 1) x pitch uint32, flattened: the tile's integral of x
    (modulo 2^32) with row 0 and column 0 zero; what the tile leaves
    unbuilt holds noise, so a read there shows."""
    out = rng.integers(0, 2**32, (rows + 1, pitch), dtype=np.uint64).astype(np.uint32)
    ph, pw = x.shape
    out[0, :pw + 1] = 0
    out[1:ph + 1, 0] = 0
    out[1:ph + 1, 1:pw + 1] = np.cumsum(np.cumsum(x.astype(np.uint32), 0, dtype=np.uint32), 1,
                                        dtype=np.uint32)
    return out.reshape(-1)


def _tile_tilted(pix, rows, pitch, rng):
    """The tile's tilted integral: the kernel's row recurrence over rows
    padded with phe + 1 zero columns each side, cropped, in a (rows + 1) x
    pitch uint32 frame of noise."""
    phe, pwe = pix.shape
    p = phe + 1
    rl = pwe + 2 * p + 1
    x = np.arange(rl)
    xc = x - 1 - p
    inb = (xc >= 0) & (xc < pwe)
    tm2, tm1 = np.zeros(rl, np.int64), np.zeros(rl, np.int64)
    out = rng.integers(0, 2**32, (rows + 1, pitch), dtype=np.uint64).astype(np.uint32)
    out[0, :pwe + 1] = 0
    for y in range(phe):
        r1 = np.where(inb, pix[y, np.clip(xc, 0, pwe - 1)], 0)
        r0 = np.where(inb, pix[y - 1, np.clip(xc, 0, pwe - 1)], 0) if y > 0 else 0
        left = np.concatenate([[0], tm1[:-1]])
        right = np.concatenate([tm1[1:], [0]])
        tn = left + right - tm2 + r1 + r0
        out[y + 1, :pwe + 1] = tn[p:p + pwe + 1].astype(np.uint32)
        tm2, tm1 = tm1, tn
    return out.reshape(-1)


def _corner4(img, a, b, c, d):
    return (img[a] - img[b] - img[c] + img[d]).view(np.int32).astype(np.int64)


def _leaves(kind, t, trees, feats, S, T, base, nf, ww, pitch):
    """Tree t's leaf for the windows at base (their tile corners)."""
    k = int(trees.feature[t])
    if kind == mine.KIND_LBP:
        pts = _tile_off(feats.points[k].numpy(), ww, pitch)
        gp = np.stack([S[base + o].view(np.int32).astype(np.int64) for o in pts], 1)
        cs = [gp[:, r * 4 + c] - gp[:, r * 4 + c + 1] - gp[:, (r + 1) * 4 + c]
              + gp[:, (r + 1) * 4 + c + 1] for r in range(3) for c in range(3)]
        code = sum((cs[i] >= cs[4]).astype(np.int64) << b
                   for i, b in ((0, 7), (1, 6), (2, 5), (5, 4), (8, 3), (7, 2), (6, 1), (3, 0)))
        words = trees.subsets[t].numpy().view(np.uint32)
        left = ((words[code >> 5] >> (code & 31)) & 1) != 0
    else:
        off = _tile_off(feats.offsets[k].numpy().reshape(-1), ww, pitch).reshape(3, 4)
        img = T if (kind == mine.KIND_HAAR_TILTED and int(feats.tilted[k])) else S
        raw = np.zeros(len(base), np.int64)
        for r in range(3):
            w = int(feats.weights[k, r])
            if w != 0:
                raw += w * _corner4(img, *(base + o for o in off[r]))
        raw = raw.astype(np.int32)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.where(nf != 0, raw.astype(np.float32) / nf, np.float32(0))
        left = v <= trees.thr[t].numpy()
    return np.where(left, trees.left[t].numpy(), trees.right[t].numpy()).astype(np.float64)


def _tile_schedule(table, kind, tx, ty):
    """The tile kernel's schedule: for every CTA of the launch (its table
    row found by a binary search over the rows' first tiles), the
    window grid indices of its tile, its windows' thread slots and
    output indices, and the tile's origin → a list of dicts."""
    starts = table[:, mine.TILE + kind]
    n_tiles = 0
    if len(table):
        last = table[-1]
        n_tiles = int(last[mine.TILE + kind] + mine.run_tiles(
            last[mine.NX], last[mine.W0], last[mine.COUNT], tx, ty))
    out = []
    tid = np.arange(mine.THREADS)
    a, b = tid // tx, tid % tx
    for blk in range(n_tiles):
        lo = int(np.searchsorted(starts, blk, side="right") - 1)
        row = table[lo]
        nx, w0, cnt = int(row[mine.NX]), int(row[mine.W0]), int(row[mine.COUNT])
        r0, r1 = w0 // nx, (w0 + cnt - 1) // nx
        tiles_x = -(-nx // tx)
        k = blk - int(row[mine.TILE + kind])
        gy0, gx0 = r0 + (k // tiles_x) * ty, (k % tiles_x) * tx
        ncol, nrow = min(tx, nx - gx0), min(ty, r1 - gy0 + 1)
        q = (gy0 + a) * nx + gx0 + b
        has = (tid < tx * ty) & (a < nrow) & (b < ncol) & (q >= w0) & (q < w0 + cnt)
        out.append({"row": row, "gy0": gy0, "gx0": gx0, "ncol": ncol, "nrow": nrow,
                    "a": a[has], "b": b[has], "g": int(row[mine.OUT]) + q[has] - w0})
    return out


def _tile_kernel_in_numpy(levels, feats, trees, ww, wh, hand_live=mine.HAND_LIVE):
    """csrc/mine.cu's tile kernel in numpy, tile by tile → ((n,) uint8,
    (n,) writes a window, the largest count of survivors handed over)."""
    kind = feats.kind
    tx, ty = levels.shapes[kind]
    lay = mine.tile_layout(ww, wh, kind, tx, ty)
    pitch = lay["pitch"]
    sx, sy, rh, rw = ww // 2, wh // 2, wh - 2, ww - 2
    table = levels.table.numpy()
    lazy, eager = levels.lazy.numpy(), levels.eager.numpy()
    out = np.zeros(levels.n, np.uint8)
    writes = np.zeros(levels.n, np.int64)
    ends = trees.stage_end.numpy().astype(np.int64)
    sthr = trees.stage_thr.numpy()
    rng = np.random.default_rng(0)
    handed = 0
    for tile in _tile_schedule(table, kind, tx, ty):
        row = tile["row"]
        y0 = int(row[mine.OY]) + tile["gy0"] * sy
        x0 = int(row[mine.OX]) + tile["gx0"] * sx
        pwe, phe = sx * (tile["ncol"] - 1) + ww, sy * (tile["nrow"] - 1) + wh
        assert pwe <= lay["pw"] and phe <= lay["ph"]
        pix = _tile_pixels(row, lazy, eager, y0, x0, phe, pwe)
        base = tile["a"] * sy * pitch + tile["b"] * sx
        g = tile["g"]
        at = base + pitch + 1
        corners = (at, at + rw, at + rh * pitch, at + rh * pitch + rw)
        nf = np.zeros(len(g), np.float32)
        if kind != mine.KIND_LBP:  # a window row's column sums of squares, a window's columns
            vsum = np.stack([(pix[a * sy + 1:a * sy + 1 + rh] ** 2).sum(0)
                             for a in range(tile["nrow"])])
            sq = np.array([vsum[a, b * sx + 1:b * sx + 1 + rw].sum()
                           for a, b in zip(tile["a"], tile["b"])], np.int64).reshape(-1)
        S = _tile_integral(pix, lay["ph"], pitch, rng)
        T = _tile_tilted(pix, lay["ph"], pitch, rng) if kind == mine.KIND_HAAR_TILTED else None
        if kind != mine.KIND_LBP:
            tot = _corner4(S, *corners)
            val = np.maximum(rh * rw * sq - tot * tot, 0)
            nf = np.sqrt(val.astype(np.float64)).astype(np.float32)
        # the short stages, a thread a window
        walk, start = _Walk(len(g)), np.zeros(len(g))
        alive = np.ones(len(g), bool)
        si, hand = 0, False
        while si < len(ends):
            tb, te = (int(ends[si - 1]) if si else 0), int(ends[si])
            live = int(alive.sum())
            if live == 0:
                break
            if te - tb >= mine.STAGE_MAX or live <= hand_live:
                hand = True
                break
            pref = start.copy()
            for t in range(tb, te):
                pref = walk.add(_leaves(kind, t, trees, feats, S, T, base, nf, ww, pitch))
            rej = alive & (pref - start < sthr[si] - EPS)
            out[g[rej]] = 0
            writes[g[rej]] += 1
            alive &= ~rej
            start = np.where(alive, pref, start)
            si += 1
        if not hand:
            out[g[alive]] = 1
            writes[g[alive]] += 1
            continue
        # the hand-off: each survivor a warp, 32 trees a step, every lane
        # the same walk over the step's leaves
        handed = max(handed, int(alive.sum()))
        w, st, gs = walk.take(alive), start[alive], g[alive]
        bs, wnf = base[alive], nf[alive]
        ok = np.ones(len(gs), bool)
        s, t_end = si, int(ends[-1])
        te = int(ends[s]) - 1
        t0 = int(ends[s - 1]) if s else 0
        while ok.any() and s < len(ends) and t0 < t_end:
            x = [_leaves(kind, t, trees, feats, S, T, bs, wnf, ww, pitch)
                 for t in range(t0, min(t0 + 32, t_end))]
            for j in range(min(32, t_end - t0)):
                pref = w.add(x[j])
                while t0 + j == te:
                    ok &= ~(pref - st < sthr[s] - EPS)
                    st = pref
                    s += 1
                    if s == len(ends):
                        break
                    te = int(ends[s]) - 1
                if not ok.any() or s == len(ends):
                    break
            t0 += 32
        out[gs] = ok
        writes[gs] += 1
    return out, writes, handed


# -- the cases -----------------------------------------------------------------


def _jax_evaluator(feature, ww, wh):
    if feature == "LBP":
        return JLBPTrainEvaluator(jfeatures.lbp_catalog(ww, wh))
    return JHaarTrainEvaluator(jfeatures.haar_catalog(ww, wh, feature))


def _case(feature, ww, wh, sizes, seed, pass_rate):
    """(the port's levels and stages, the JAX package's levels and
    stages) of one case; the JAX stages are built from the specs and the
    port's taken from them by stages_from_jax. Past 17 trees the stage
    thresholds sit on windows that a prefix in another order than
    scan_cumsum's would judge the other way (stump_specs's knife)."""
    levels, _stages, specs = edges.mine_case(feature, ww, wh, sizes, seed, pass_rate=pass_rate,
                                             knife=sum(sizes) > 17)
    jstages = edges.stages_of(specs, JStage, JWeakTree)
    jlevels = edges.levels_of(edges.mine_level_specs(seed, ww, wh), JLazyLevel)
    return levels, stages_from_jax(jstages), jlevels, jstages


CASES = [
    ("BASIC", 12, (1,), 0.4), ("BASIC", 12, (16,), 0.75), ("BASIC", 12, (5, 12), 0.75),
    ("BASIC", 12, (3, 17, 20), 0.8), ("BASIC", 12, (100, 156), 0.8),
    ("BASIC", 12, (16, 240, 45), 0.8), ("BASIC", 24, (17,), 0.75),
    ("BASIC", 24, (255, 2), 0.75), ("ALL", 12, (3, 17, 20), 0.8),
    ("ALL", 24, (16, 240, 45), 0.8), ("LBP", 12, (5, 12), 0.75), ("LBP", 24, (100, 201), 0.8),
]


@pytest.mark.parametrize("feature,side,sizes,pass_rate", CASES,
                         ids=[f"{f}-{s}-{sum(z)}" for f, s, z, _ in CASES])
def test_mine_matches_original(feature, side, sizes, pass_rate):
    """The port's dense predict_levels (mine_ref) and the kernel's replay
    give the JAX package's dense masks."""
    seed = 50 + sum(sizes) + side
    levels, stages, jlevels, jstages = _case(feature, side, side, sizes, seed, pass_rate)
    want = JPredictor(lambda: _jax_evaluator(feature, side, side), jstages).predict_levels(
        jlevels, side, side)
    ev = edges.mine_evaluator(feature, side, side, "cpu")
    got = CascadePredictor(lambda: ev, stages).predict_levels(levels, side, side)
    assert [len(g) for g in got] == [len(lv[1]) for lv in levels]
    flat = np.concatenate(got)
    assert 0.05 <= flat.mean() <= 0.95
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    args = edges.mine_inputs(feature, side, side, levels, stages, "cpu")
    np.testing.assert_array_equal(_mine_kernel_in_numpy(*args, side, side), flat)


@pytest.mark.parametrize("case", range(N_EDGES))
def test_kernel_replay_edge_cases(case):
    """utils/edges.py's miner edges (the cases chip_smoke runs on the
    card): the kernel's replay equals mine_ref."""
    label, feature, ww, wh, levels, stages = list(edges.mine_edge_cases())[case]
    args = edges.mine_inputs(feature, ww, wh, levels, stages, "cpu")
    want = mine.mine_ref(*args, ww, wh).numpy()
    np.testing.assert_array_equal(_mine_kernel_in_numpy(*args, ww, wh), want, err_msg=label)


def test_edge_cases_count():
    assert len(list(edges.mine_edge_cases())) == N_EDGES


@pytest.mark.parametrize("feature,side,sizes,pass_rate", CASES,
                         ids=[f"{f}-{s}-{sum(z)}" for f, s, z, _ in CASES])
def test_tile_kernel_matches_original(feature, side, sizes, pass_rate):
    """The tile kernel's replay gives the JAX package's dense masks, each
    window written once."""
    seed = 50 + sum(sizes) + side
    levels, stages, jlevels, jstages = _case(feature, side, side, sizes, seed, pass_rate)
    want = JPredictor(lambda: _jax_evaluator(feature, side, side), jstages).predict_levels(
        jlevels, side, side)
    args = edges.mine_inputs(feature, side, side, levels, stages, "cpu")
    got, writes, _handed = _tile_kernel_in_numpy(*args, side, side)
    np.testing.assert_array_equal(got, np.concatenate(want).astype(np.uint8))
    assert (writes == 1).all()


@pytest.mark.parametrize("case", range(N_EDGES))
def test_tile_replay_edge_cases(case):
    """utils/edges.py's miner edges (the cases chip_smoke runs on the
    card): the tile kernel's replay equals mine_ref whether survivors are
    handed over at the kernel's threshold, never before a long stage, or
    at the first stage, and writes each window once."""
    label, feature, ww, wh, levels, stages = list(edges.mine_edge_cases())[case]
    args = edges.mine_inputs(feature, ww, wh, levels, stages, "cpu")
    want = mine.mine_ref(*args, ww, wh).numpy()
    for hand_live in (mine.HAND_LIVE, 0, 10 ** 9):
        got, writes, handed = _tile_kernel_in_numpy(*args, ww, wh, hand_live=hand_live)
        np.testing.assert_array_equal(got, want, err_msg=f"{label}, hand_live {hand_live}")
        assert (writes == 1).all(), label
        if hand_live == 10 ** 9 and args[2].stage_end.numel():
            assert handed > 0, label


@pytest.mark.parametrize("n_trees", [1, 15, 16, 17, 31, 32, 33, 255, 256, 257, 300, 4097])
def test_walk_prefix_is_scan_cumsum(n_trees):
    """Bit (1) a thread at a time: the Walk a thread (or a warp, after
    the hand-off) carries equals scan_cumsum's blocked order bit for bit."""
    rng = np.random.default_rng(n_trees + 7)
    for leaves in (rng.normal(0, 1, (64, n_trees)).astype(np.float32).astype(np.float64),
                   rng.normal(0, 1, (64, n_trees))):
        got = _walk_prefix(leaves)
        want = scan_cumsum(torch.from_numpy(leaves.T.copy())).numpy().T
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
        np.testing.assert_array_equal(got, _stream_prefix(leaves))


@pytest.mark.parametrize("side", [12, 24])
def test_tile_tilted_corners_equal_window_local(side):
    """Every tilted rect of Haar ALL, by its 4 corners in the tile's tilted
    integral at the window's tile offset, equals the same corners of the
    window's own integral_tilted, for windows on each of a tile's four
    edges (random pixels, so any pixel outside the rect would show)."""
    cat = haar_catalog(side, side, "ALL")
    ids = np.flatnonzero(cat.tilted)
    off = cat.corner_offsets()[ids]  # (K, 3, 4) window-local
    used = cat.weights[ids] != 0
    tx, ty = mine.tile_shape(side, side, mine.KIND_HAAR_TILTED)
    lay = mine.tile_layout(side, side, mine.KIND_HAAR_TILTED, tx, ty)
    pitch, s = lay["pitch"], side // 2
    rng = np.random.default_rng(side)
    pix = rng.integers(0, 256, (lay["ph"], lay["pw"])).astype(np.int64)
    tilt = _tile_tilted(pix, lay["ph"], pitch, rng)
    edge = {(a, b) for a in range(ty) for b in range(tx) if a in (0, ty - 1) or b in (0, tx - 1)}
    assert len(edge) >= 4
    toff = _tile_off(off.reshape(-1), side, pitch).reshape(off.shape)
    for a, b in sorted(edge):
        win = pix[a * s:a * s + side, b * s:b * s + side]
        local = integral_tilted(torch.from_numpy(win.astype(np.uint8))[None]).numpy()
        local = local.reshape(-1).astype(np.int64)
        want = local[off[..., 0]] - local[off[..., 1]] - local[off[..., 2]] + local[off[..., 3]]
        base = a * s * pitch + b * s
        got = _corner4(tilt, *(base + toff[..., i] for i in range(4)))
        np.testing.assert_array_equal(np.where(used, got, 0), np.where(used, want, 0),
                                      err_msg=f"window ({a}, {b}) of a {tx}x{ty} tile")


def _superbatches(tmp_path, side, count=3, windows=3000):
    """time_mine.superbatches of small noise backgrounds at side x side,
    the reader left mid-level between them (as the trainer's rewind
    leaves it), so each superbatch after the first starts on a partial
    level."""
    names = []
    for k in range(4):
        names.append(str(tmp_path / f"bg{k}.pgm"))
        train_data.write_pgm(names[-1], np.random.default_rng(k).integers(
            0, 256, (90 + 17 * k, 140 - 9 * k)).astype(np.uint8))
    bg = tmp_path / "bg.txt"
    bg.write_text("\n".join(names) + "\n")
    reader = NegReader(str(bg), side, side, lazy=True)
    out = []
    for i in range(count):
        out += time_mine.superbatches(reader, 1, windows)
        for _ in range(50):  # to a window inside a grid row
            pos = reader.level_positions()[1]
            if pos.first % pos.nx:
                break
            reader.skip(1)
    return out


@pytest.mark.parametrize("side", [12, 24])
def test_pack_levels_from_grid_runs(tmp_path, side):
    """The reader's GridRun levels give the table their positions as
    arrays give, without building a position (no per-window pass), and
    the tile kernel's replay gives mine_ref's masks on them."""
    batches = _superbatches(tmp_path, side)
    assert len(batches) == 3
    assert all(levels[0][1].first % levels[0][1].nx for levels in batches[1:])
    for levels in batches:
        assert all(isinstance(lv[1], GridRun) for lv in levels)
        packed = mine.pack_levels(levels, side, side, "cpu")
        assert not any(lv[1].materialized for lv in levels)
        arrays = [(img, np.asarray(pos), key) for img, pos, key in levels]
        want = mine.pack_levels(arrays, side, side, "cpu")
        np.testing.assert_array_equal(packed.table.numpy(), want.table.numpy())
        assert (packed.n, packed.counts, packed.tiles) == (want.n, want.counts, want.tiles)
        assert len(packed.table) == sum(1 for c in packed.counts if c)
    stages = edges.mine_case("BASIC", side, side, (2, 2, 4), 5)[1]
    args = edges.mine_inputs("BASIC", side, side, batches[0], stages, "cpu")
    got, writes, _ = _tile_kernel_in_numpy(*args, side, side)
    np.testing.assert_array_equal(got, mine.mine_ref(*args, side, side).numpy())
    assert (writes == 1).all()


def test_grid_run_rows_past_their_level_raise():
    img = np.zeros((40, 40), np.uint8)
    with pytest.raises(ValueError, match="past"):
        mine.pack_levels([(img, GridRun(0, 0, 6, 6, 6, 0, 7), 0)], 12, 12, "cpu")
    with pytest.raises(ValueError, match="grid"):
        mine.pack_levels([(img, GridRun(0, 0, 5, 6, 4, 0, 4), 0)], 12, 12, "cpu")


@pytest.mark.parametrize("kind", mine.KINDS)
def test_tile_schedule_covers_every_window_once(tmp_path, kind):
    """The tile kernel's CTAs, each finding its row by the binary search
    over the rows' first tiles, cover every window of every run exactly
    once, inside the tile, at its output index."""
    tables = [mine.pack_levels(edges.levels_of(
        edges.mine_level_specs(3, side, side) + edges.tile_level_specs(4, side, side, kind),
        LazyLevel), side, side, "cpu") for side in (12, 24)]
    tables.append(mine.pack_levels(_superbatches(tmp_path, 24, 1)[0], 24, 24, "cpu"))
    for packed, side in zip(tables, (12, 24, 24)):
        tx, ty = packed.shapes[kind]
        sched = _tile_schedule(packed.table.numpy(), kind, tx, ty)
        assert len(sched) == packed.tiles[kind]
        g = np.concatenate([t["g"] for t in sched])
        np.testing.assert_array_equal(np.sort(g), np.arange(packed.n))
        for t in sched:
            assert (t["a"] < ty).all() and (t["b"] < tx).all()


def test_tile_layout_mirrors_the_source():
    """train/mine.py's tile constants are csrc/mine.cu's."""
    with open(os.path.join(_build.CSRC_DIR, "mine.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == mine.THREADS
    assert const("kStageMax") == mine.STAGE_MAX
    assert const("kRec") == mine.REC_INTS
    assert const("kMaxShared") == mine.MAX_SHARED
    assert const("kMinBlocks") == mine.MIN_BLOCKS
    size = int(re.search(r"static_assert\(sizeof\(HandState\) == (\d+)", src).group(1))
    assert size == 4 * mine.HAND_INTS
    cols = re.search(r"enum Col \{([^}]*)\}", src).group(1)
    assert "kCols = kTile + 3" in cols and cols.split(",").index(" kTile") == mine.TILE
    assert len(mine.LEVEL_COLS) == mine.TILE + 3


def test_tile_off_is_exact():
    """The kernel's multiply-high row of a corner offset is o // (ww + 1)
    for every offset of a window up to 256 x 256."""
    for ww in range(2, 257):
        o = np.arange((ww + 1) * 257)
        np.testing.assert_array_equal(_tile_off(o, ww, 1000), (o // (ww + 1)) * 1000 + o % (ww + 1))


def test_mine_warp_runs_on_a_card_only():
    args = edges.mine_inputs("BASIC", 12, 12, *list(edges.mine_edge_cases())[0][4:], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mine.mine_warp(*args, 12, 12)


@pytest.mark.parametrize("n_trees", [1, 15, 16, 17, 31, 32, 33, 255, 256, 257, 300, 4097])
def test_stream_prefix_is_scan_cumsum(n_trees):
    """Bit (1): the kernel's streaming prefix equals scan_cumsum's blocked
    order bit for bit past every block boundary; a running sum in tree
    order does not (f64 leaves, once a second block holds two trees)."""
    rng = np.random.default_rng(n_trees)
    for leaves in (rng.normal(0, 1, (64, n_trees)).astype(np.float32).astype(np.float64),
                   rng.normal(0, 1, (64, n_trees))):
        got = _stream_prefix(leaves)
        want = scan_cumsum(torch.from_numpy(leaves.T.copy())).numpy().T
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
    if n_trees > 17:
        assert not np.array_equal(np.cumsum(leaves, axis=1), want)


def test_stream_prefix_of_negative_zero_leaves():
    """-0.0 leaves: the streaming prefix and scan_cumsum agree as values
    (a zero sum's sign may differ at the top level; no compare sees it)."""
    leaves = np.full((4, 40), -0.0)
    leaves[1, ::3] = 1.5
    np.testing.assert_array_equal(_stream_prefix(leaves),
                                  scan_cumsum(torch.from_numpy(leaves.T.copy())).numpy().T)


def _levels_for_packing():
    specs = edges.mine_level_specs(7, 12, 12)
    levels = edges.levels_of(specs, LazyLevel)
    img, pos, key = levels[0]
    rng = np.random.default_rng(3)
    scattered = pos[np.sort(rng.choice(len(pos), 9, replace=False))]  # several runs
    return levels + [(img, scattered, key), (img, pos[::-1], key)]


def test_pack_levels_covers_positions_in_order():
    levels = _levels_for_packing()
    packed = mine.pack_levels(levels, 12, 12, "cpu")
    table = packed.table.numpy()
    assert packed.counts == [len(lv[1]) for lv in levels]
    assert packed.n == sum(packed.counts) == int(table[:, mine.COUNT].sum())
    assert (table[:, mine.COUNT] > 0).all()
    np.testing.assert_array_equal(table[:, mine.OUT],
                                  np.concatenate(([0], np.cumsum(table[:-1, mine.COUNT]))))
    got = []
    for row in table:
        q = row[mine.W0] + np.arange(row[mine.COUNT])
        got.append(np.stack([row[mine.OX] + (q % row[mine.NX]) * 6,
                             row[mine.OY] + (q // row[mine.NX]) * 6], 1))
    want = np.concatenate([lv[1] for lv in levels if len(lv[1])])
    np.testing.assert_array_equal(np.concatenate(got), want)
    wins = mine.level_windows(packed, 12, 12).numpy()
    crops = np.stack([np.asarray(img[py:py + 12, px:px + 12])
                      for img, pos, _k in levels for px, py in pos])
    np.testing.assert_array_equal(wins, crops)
    np.testing.assert_array_equal(_pixels_in_numpy(packed, 12, 12), crops)
    # the schedule's levels (partial first row, then full rows) take a row
    # each, the empty one none
    assert int((table[:, mine.OUT] < sum(packed.counts[:6])).sum()) == 5


def test_pack_levels_reuses_arena_sources():
    levels = edges.levels_of(edges.mine_level_specs(7, 12, 12), LazyLevel)
    arena = mine.SourceArena("cpu")
    first = mine.pack_levels(levels, 12, 12, "cpu", arena)
    used = arena.used
    second = mine.pack_levels(levels[::-1], 12, 12, "cpu", arena)
    assert arena.used == used
    lazy0 = first.table[first.table[:, mine.EAGER] == 0][:, mine.SRC_OFF]
    assert set(lazy0.tolist()) <= set(second.table[:, mine.SRC_OFF].tolist())


def test_arena_starts_over_past_its_cap(monkeypatch):
    """Past ARENA_CAP_BYTES the arena drops its sources and holds those of
    the call at hand; the windows stay the levels' own."""
    levels = [lv for lv in edges.levels_of(edges.mine_level_specs(7, 12, 12), LazyLevel)
              if hasattr(lv[0], "src") and len(lv[1])]
    sizes = {(lv[0].src_id, lv[0].src.shape): lv[0].src.size for lv in levels}
    assert len(sizes) >= 2
    monkeypatch.setattr(mine, "ARENA_CAP_BYTES", max(sizes.values()))
    arena = mine.SourceArena("cpu")
    for lv in levels + levels[::-1]:
        packed = mine.pack_levels([lv], 12, 12, "cpu", arena)
        assert arena.used <= mine.ARENA_CAP_BYTES and len(arena.offsets) == 1
        crops = np.stack([np.asarray(lv[0][py:py + 12, px:px + 12]) for px, py in lv[1]])
        np.testing.assert_array_equal(mine.level_windows(packed, 12, 12).numpy(), crops)


@pytest.mark.parametrize("bad", ["off grid", "past the level"])
def test_pack_levels_rejects_positions(bad):
    img = np.zeros((40, 40), np.uint8)
    pos = np.array([[0, 0], [6, 0], [3, 0]] if bad == "off grid" else [[0, 0], [30, 0]])
    with pytest.raises(ValueError):
        mine.pack_levels([(img, pos, 0)], 12, 12, "cpu")


@pytest.mark.parametrize("feature,side", [("BASIC", 24), ("ALL", 24), ("LBP", 24),
                                          ("BASIC", 20)])
def test_check_exact_holds_for_whole_catalogs(feature, side):
    ev = edges.mine_evaluator(feature, side, side, "cpu")
    feats = mine.features_of(ev, np.arange(ev.num_features))
    assert 0 < mine.exact_bound(feats, side, side) <= mine.EXACT_LIMIT


@pytest.mark.parametrize("what", ["weight", "window", "lbp"])
def test_check_exact_fires_beyond_2_24(what):
    """Bit (3): a synthetic feature whose partial sums may pass 2^24: a
    BASIC feature at 24x24 with its weights x 4096; an x2 feature over a
    256x256 window (255 · 256² · 3 > 2^24); LBP cells of 100x100 pixels
    in a 300x300 window."""
    if what == "lbp":
        c = np.array([0, 100, 200, 300])
        pts = (c[None, :] + 301 * c[:, None]).reshape(1, 16)
        feats = mine.Features(points=torch.from_numpy(pts).to(torch.int32))
        with pytest.raises(ValueError, match="2\\^24"):
            mine.check_exact(feats, 300, 300)
        return
    if what == "weight":
        side = 24
        ev = edges.mine_evaluator("BASIC", side, side, "cpu")
        off, w, til = ev.kernel_records(torch.tensor([len(ev.catalog) - 1]))
        w = w * 4096
    else:
        side = 256
        rects = np.array([[0, 0, side, side], [0, 0, side // 2, side], [0, 0, 0, 0]])
        off = np.stack(sum_offsets(*rects.T, side + 1), axis=-1)[None]
        off = torch.from_numpy(off).to(torch.int32)
        w = torch.tensor([[-1, 2, 0]], dtype=torch.int32)
        til = torch.zeros(1, dtype=torch.int32)
    feats = mine.Features(offsets=off, weights=w, tilted=til)
    with pytest.raises(ValueError, match="2\\^24"):
        mine.check_exact(feats, side, side)


def test_exact_check_guards_the_kernel_only():
    """Bit (3) holds the kernel to the plain version: its wrapper raises
    beyond 2^24 before a launch, while the plain version mines such
    features, as the JAX package does."""
    ev = edges.mine_evaluator("BASIC", 24, 24, "cpu")
    feats = mine.features_of(ev, [len(ev.catalog) - 1])
    feats.weights = feats.weights * 4096
    img = np.random.default_rng(3).integers(0, 256, (48, 48), dtype=np.uint8)
    pos = np.array([[x, y] for y in (0, 12, 24) for x in (0, 12, 24)])
    packed = mine.pack_levels([(img, pos, 0)], 24, 24, "cpu")
    trees = mine.Trees(torch.zeros(1, dtype=torch.int32), torch.zeros(1), torch.ones(1),
                       -torch.ones(1), None, torch.ones(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="2\\^24"):
        mine._check_args(packed, feats, trees, 24, 24)
    got = mine.mine(packed, feats, trees, 24, 24)
    torch.testing.assert_close(got, mine.mine_ref(packed, feats, trees, 24, 24), rtol=0, atol=0)
    assert got.shape == (9,)


def test_tilted_edge_features_touch_the_edge():
    cat = haar_catalog(24, 24, "ALL")
    ids = edges.tilted_edge_features(cat)
    assert len(ids) > 100 and cat.tilted[ids].all()
    off = cat.corner_offsets()[ids]
    col, row = off % 25, off // 25
    used = cat.weights[ids] != 0
    touch = ((col == 0) | (col == 24) | (row == 24)) & used[:, :, None]
    assert touch.any(axis=(1, 2)).all()


def test_empty_inputs():
    """No windows: an empty mask; no stages: every window accepted."""
    ev = edges.mine_evaluator("BASIC", 12, 12, "cpu")
    levels = edges.levels_of(edges.mine_level_specs(7, 12, 12), LazyLevel)
    stages = edges.mine_case("BASIC", 12, 12, (3,), 9)[1]
    feats, trees = mine.features_of(ev, [0]), mine.tree_table([], [0], False, "cpu")
    packed = mine.pack_levels(levels, 12, 12, "cpu")
    assert mine.mine(packed, feats, trees, 12, 12).tolist() == [1] * packed.n
    empty = mine.pack_levels([(levels[4][0], levels[4][1], 0)], 12, 12, "cpu")
    assert empty.n == 0 and mine.mine(empty, feats, trees, 12, 12).numel() == 0
    pred = CascadePredictor(lambda: ev, stages)
    assert pred.predict_levels([], 12, 12) == []
    assert [len(x) for x in pred.predict_levels(levels[4:5], 12, 12)] == [0]
