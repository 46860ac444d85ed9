"""Times the dense miner on real superbatches: the kernel
(``train/mine.py::mine``, ``csrc/mine.cu``'s tile kernel), the design it
replaced (``mine_warp``, a warp a window), its plain version
(``mine_ref``) and a library composite, each from the trainer's levels to
the mask on the host.

    python3 -m cascadeclassifier_tpu_torch.utils.time_mine [--superbatches N]

Needs a CUDA device and nvcc. The data are chip_smoke (s)'s: the 20
clutter backgrounds of ``utils/train_data.py`` (1080x1920, seeds 100-119)
written as PGM into ``_time_mine/`` in the checkout (removed at the end),
read by ``NegReader(lazy=True)`` at 24x24, and superbatches of 131 072
windows gathered as ``CascadeTrainer._fill_negatives`` gathers them.
Run alone, the cascade is 3 stages of 2, 2 and 4 Haar BASIC stumps built
by ``utils/edges.py::stump_specs`` on the first superbatch's windows, each
passing about 40 % of its survivors (chip_smoke hands over (s)'s trained
stages instead).

Per superbatch and path: the host's ms from the levels to the host mask
(``pack_levels`` and the launch and the fetch for the kernel, first with
the upload of the superbatch's new sources into the arena, as the
trainer meets them, then again with the sources on the card, in turns
with the replaced design; ``mine_ref`` with its level builds for the plain
version; the composite on the same windows built beforehand, which its
time leaves out), levels, windows, launches (the kernels' counted by
their wrappers; the others' device kernels traced by torch.profiler on
the first superbatch) and windows/s; and the kernel path's parts apart:
``pack_levels`` alone (host ms to the end of its uploads), the launch
alone in CUDA events (the tile kernel's and the replaced design's, in
turns on the same packed table) and the mask's fetch (host ms). Every
superbatch's masks of both kernels must equal the plain version's.
``hand_off_sweep`` times the tile kernel at several hand-off counts
(``mine.HAND_LIVE``) on one superbatch, under the given stages and under
a deeper synthetic cascade of 3, 6, 12, 24 and 48 stumps. The composite
is ``torch.cumsum`` integrals, a ``torch.matmul`` corner product with
TF32 off, the division, a ``torch.cumsum`` f64 prefix over the trees and
``any``: a timing
yardstick for upright Haar cascades, not bit-exact (its prefix is not
``scan_cumsum``'s order). Last, ptxas's registers and spills for each
instantiation of both kernels (``_build.kernel_resources``) and, for the
tile kernel at 24x24, each kind's tile, shared bytes a CTA and CTAs an
SM (``mine.tile_info``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

WINDOWS = 131072  # the trainer's mining_batch
CV_THRESHOLD_EPS = 1e-5


def write_backgrounds(folder: str, count: int = 20) -> str:
    """(s)'s clutter backgrounds as PGM files and their list → the list's path."""
    from cascadeclassifier_tpu_torch.utils import train_data

    os.makedirs(folder, exist_ok=True)
    names = []
    for k in range(count):
        names.append(os.path.join(folder, f"bg{k}.pgm"))
        train_data.write_pgm(names[-1], train_data.background(1080, 1920, seed=100 + k))
    path = os.path.join(folder, "bg.txt")
    with open(path, "w") as f:
        f.write("\n".join(names) + "\n")
    return path


def superbatches(reader, count: int, windows: int = WINDOWS) -> list:
    """count superbatches of at least windows windows, each a list of
    (img, positions, key) levels in the schedule's order, gathered as
    ``CascadeTrainer._fill_negatives`` gathers them."""
    out = []
    for _ in range(count):
        levels, total = [], 0
        while total < windows:
            lvl = reader.level_positions()
            if lvl is None:
                return out
            img, pos = lvl
            levels.append((img, pos, (reader.last, float(reader.scale))))
            total += len(pos)
            if not reader.skip(len(pos)):
                break
        out.append(levels)
    return out


def composite_tables(feats, trees, ww: int, wh: int):
    """The composite's corner matrix (K, P) and walk arguments (upright
    Haar only)."""
    from cascadeclassifier_tpu_torch.train import mine
    from cascadeclassifier_tpu_torch.train.evaluators import corner_matrix

    if feats.points is not None or feats.has_tilted:
        raise ValueError("the library composite times upright Haar cascades only")
    m_up = corner_matrix(feats.offsets, feats.weights.to(torch.float32), (ww + 1) * (wh + 1))
    return m_up, mine.walk_args(trees)


def library_composite(wins, m_up, walk):
    """(n, wh, ww) uint8 windows → (n,) bool accepts by library calls
    (a timing yardstick, not bit-exact): cumsum integrals, the norm
    factor, an f32 matmul (TF32 off), the division, a cumsum f64 prefix."""
    ti, tt, tl, tr, _ts, bs, be, sthr = walk
    x = wins.to(torch.int32)
    s = F.pad(torch.cumsum(torch.cumsum(x, 2), 1), (1, 0, 1, 0))
    q = F.pad(torch.cumsum(torch.cumsum(x.long() * x, 2), 1), (1, 0, 1, 0))
    h, w = wins.shape[1] - 2, wins.shape[2] - 2

    def rect(a):
        a = a.long()
        return a[:, 1, 1] - a[:, 1, 1 + w] - a[:, 1 + h, 1] + a[:, 1 + h, 1 + w]

    tot = rect(s)
    nf = torch.sqrt((h * w * rect(q) - tot * tot).clamp(min=0).double()).float()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        raw = torch.matmul(m_up, s.reshape(s.shape[0], -1).float().T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    vals = torch.where(nf != 0, raw / torch.where(nf == 0, 1.0, nf), 0.0)
    leaf = torch.where(vals[ti] <= tt[:, None], tl[:, None], tr[:, None]).double()
    pref = torch.cumsum(leaf, 0)
    starts = torch.where((bs > 0)[:, None], pref[(bs - 1).clamp(min=0)], 0.0)
    return ~((pref[be - 1] - starts) < sthr[:, None] - CV_THRESHOLD_EPS).any(0)


def traced_kernels(fn) -> int:
    """Device kernels torch.profiler traces in one call of fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def wall_ms(fn):
    """(host ms of fn() to a synchronized end, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def event_ms(fn) -> float:
    """Device ms of one fn() by CUDA events (after a synchronize)."""
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def time_superbatches(ev, stages, batches, ww: int, wh: int, dev) -> list:
    """Each superbatch through the kernel, the replaced design, the plain
    version and the composite → one dict a superbatch (see the module
    docstring); raises where a kernel's mask differs from the plain
    version's."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.train import mine

    used = sorted({int(t.feature_idx[0]) for s in stages for t in s.trees})
    feats = mine.features_of(ev, used)
    trees = mine.tree_table(stages, used, ev.maxCatCount > 0, dev)
    comp = composite_tables(feats, trees, ww, wh) if feats.kind == mine.KIND_HAAR else None
    arena = mine.SourceArena(dev)
    warm = mine.pack_levels(batches[0], ww, wh, dev, arena)
    mine.mine(warm, feats, trees, ww, wh)
    mine.mine_warp(warm, feats, trees, ww, wh)
    rows = []
    for i, levels in enumerate(batches):
        before = _build.LAUNCHES["mine"], _build.LAUNCHES["mine_warp"]

        def kernel(run):
            packed = mine.pack_levels(levels, ww, wh, dev, arena)
            return run(packed, feats, trees, ww, wh).cpu()

        k_ms, got = wall_ms(lambda: kernel(mine.mine))  # with the new sources' upload
        n_launch = _build.LAUNCHES["mine"] - before[0]
        w_ms, got_w = wall_ms(lambda: kernel(mine.mine_warp))
        n_warp = _build.LAUNCHES["mine_warp"] - before[1]
        k2_ms, _again = wall_ms(lambda: kernel(mine.mine))
        pack_ms, packed = wall_ms(lambda: mine.pack_levels(levels, ww, wh, dev, arena))
        launch_ms = event_ms(lambda: mine.mine(packed, feats, trees, ww, wh))
        warp_launch_ms = event_ms(lambda: mine.mine_warp(packed, feats, trees, ww, wh))
        launch_ms_2 = event_ms(lambda: mine.mine(packed, feats, trees, ww, wh))
        warp_launch_ms_2 = event_ms(lambda: mine.mine_warp(packed, feats, trees, ww, wh))
        ok = mine.mine(packed, feats, trees, ww, wh)
        fetch_ms, _host = wall_ms(lambda: ok.cpu())
        p_ms, want = wall_ms(lambda: mine.mine(
            mine.pack_levels(levels, ww, wh, dev, arena), feats, trees, ww, wh, impl="ref").cpu())
        for name, mask in (("tile kernel", got), ("replaced design", got_w)):
            if not torch.equal(mask, want):
                raise RuntimeError(f"superbatch {i}: {int((mask != want).sum())} masks of the "
                                   f"{name} differ from the plain version's")
        row = {"levels": len(levels), "windows": packed.n, "accepted": int(got.sum()),
               "kernel_ms": k_ms, "kernel_launches": n_launch, "warp_ms": w_ms,
               "kernel_warm_ms": k2_ms,
               "warp_launches": n_warp, "launch_ms": (launch_ms + launch_ms_2) / 2,
               "warp_launch_ms": (warp_launch_ms + warp_launch_ms_2) / 2,
               "pack_ms": pack_ms, "fetch_ms": fetch_ms, "plain_ms": p_ms}
        if comp is not None:
            wins = mine.level_windows(packed, ww, wh)
            c_ms, _ok = wall_ms(lambda: library_composite(wins, *comp).cpu())
            row["composite_ms"] = c_ms
            if i == 0:
                row["composite_launches"] = traced_kernels(lambda: library_composite(wins, *comp))
            del wins
        if i == 0:
            row["plain_launches"] = traced_kernels(lambda: mine.mine(
                mine.pack_levels(levels, ww, wh, dev, arena), feats, trees, ww, wh, impl="ref"))
        rows.append(row)
    return rows


def hand_off_sweep(ev, stages, levels, ww: int, wh: int, dev,
                   counts=(0, 4, 8, 16, 64, 10 ** 9)) -> dict:
    """The tile kernel's launch ms (CUDA events, mean of 5 after one) on
    one superbatch at each hand-off count, under stages and under a
    deeper synthetic cascade (3, 6, 12, 24, 48 stumps, half of each
    stage's survivors passing) → {stage sizes: {count: ms}}; every mask
    equal to the first count's."""
    from cascadeclassifier_tpu_torch.train import mine

    out = {}
    for st in (stages, synthetic_stages(ev, levels, ww, wh, seed=1, sizes=(3, 6, 12, 24, 48),
                                        pass_rate=0.5)):
        used = sorted({int(t.feature_idx[0]) for s in st for t in s.trees})
        feats = mine.features_of(ev, used)
        trees = mine.tree_table(st, used, ev.maxCatCount > 0, dev)
        packed = mine.pack_levels(levels, ww, wh, dev)
        saved, ms, first = mine.HAND_LIVE, {}, None
        try:
            for c in counts:
                mine.HAND_LIVE = c
                mask = mine.mine(packed, feats, trees, ww, wh)
                if first is None:
                    first = mask
                elif not torch.equal(mask, first):
                    raise RuntimeError(f"hand-off count {c}: masks differ")
                ms[c] = float(np.mean([event_ms(lambda: mine.mine(packed, feats, trees, ww, wh))
                                       for _ in range(5)]))
        finally:
            mine.HAND_LIVE = saved
        out[tuple(len(s.trees) for s in st)] = ms
    return out


def evaluated_trees(ev, stages, levels, ww: int, wh: int, dev) -> list:
    """Windows that reach each stage of one superbatch (the plain version
    over the stages before it)."""
    from cascadeclassifier_tpu_torch.train import mine

    packed = mine.pack_levels(levels, ww, wh, dev)
    used = sorted({int(t.feature_idx[0]) for s in stages for t in s.trees})
    feats = mine.features_of(ev, used)
    out = []
    for s in range(len(stages)):
        trees = mine.tree_table(stages[:s], used, ev.maxCatCount > 0, dev)
        out.append(int(mine.mine(packed, feats, trees, ww, wh, impl="ref").sum()))
    return out


def report(rows) -> str:
    """Means over the superbatches, a line a path."""
    def mean(k):
        return float(np.mean([r[k] for r in rows]))

    win = mean("windows")
    lines = [f"{len(rows)} superbatches, {mean('levels'):.1f} levels and {win:.0f} windows a "
             f"superbatch, {mean('accepted'):.0f} accepted"]
    for name, key, launches in (
            ("kernel", "kernel_ms", rows[0]["kernel_launches"]),
            ("kernel, the sources already on the card", "kernel_warm_ms",
             rows[0]["kernel_launches"]),
            ("replaced design (a warp a window), the sources already on the card", "warp_ms",
             rows[0]["warp_launches"]),
            ("plain", "plain_ms", rows[0].get("plain_launches")),
            ("composite", "composite_ms", rows[0].get("composite_launches"))):
        if key in rows[0]:
            ms = mean(key)
            lines.append(f"{name}: {ms:.3f} ms a superbatch (host, levels to mask), launches a "
                         f"superbatch {launches}, {win / ms * 1e3:.4g} windows/s")
    lines.append("kernel, levels to mask a superbatch, first pass (with its new sources' "
                 "upload): " + ", ".join(f"{r['kernel_ms']:.3f}" for r in rows) + " ms")
    lines.append(f"kernel path apart: pack_levels {mean('pack_ms'):.4f} ms (host, to its "
                 f"uploads' end), the launch {mean('launch_ms'):.4f} ms (CUDA events; the "
                 f"replaced design's {mean('warp_launch_ms'):.4f} on the same table, in turns), "
                 f"the fetch {mean('fetch_ms'):.4f} ms (host)")
    return "\n".join(lines)


def tile_report(ww: int, wh: int) -> list:
    """A line a kind: the tile kernel's tile, shared bytes and CTAs an SM."""
    from cascadeclassifier_tpu_torch.train import mine

    lines = []
    for kind, name in zip(mine.KINDS, ("haar", "haar_tilted", "lbp")):
        t = mine.tile_info(ww, wh, kind)
        lines.append(f"tile {name} {ww}x{wh}: {t['tile'][0]}x{t['tile'][1]} windows, "
                     f"{t['shared_bytes']} shared bytes a CTA (layout {t['layout_bytes']}), "
                     f"{t['ctas_per_sm']} CTAs an SM")
    return lines


def synthetic_stages(ev, levels, ww: int, wh: int, seed: int = 0, sizes=(2, 2, 4),
                     pass_rate: float = 0.4):
    """Stages of sizes stumps (3 stages of 2, 2 and 4) over 64 Haar
    features on the windows of levels (stump_specs, about pass_rate of
    survivors pass each)."""
    from cascadeclassifier_tpu_torch.models.model import Stage, WeakTree
    from cascadeclassifier_tpu_torch.train import mine
    from cascadeclassifier_tpu_torch.utils import edges

    rng = np.random.default_rng(seed)
    wins = mine.level_windows(mine.pack_levels(levels, ww, wh, ev.device), ww, wh)
    ids = rng.choice(ev.num_features, 64, replace=False)
    ev.set_samples(wins[:8192])
    specs = edges.stump_specs(ev.values_for_vars(ids).cpu().numpy(), ids, sizes, rng, False,
                              pass_rate=pass_rate)
    return edges.stages_of(specs, Stage, WeakTree)


def main():
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--superbatches", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mine needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    folder = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "_time_mine")
    try:
        bg = write_backgrounds(folder)
        batches = superbatches(NegReader(bg, 24, 24, lazy=True), args.superbatches)
        ev = HaarTrainEvaluator(haar_catalog(24, 24, "BASIC"), device=dev)
        stages = synthetic_stages(ev, batches[0], 24, 24)
        reach = evaluated_trees(ev, stages, batches[0], 24, 24, dev)
        rows = time_superbatches(ev, stages, batches, 24, 24, dev)
        sweep = hand_off_sweep(ev, stages, batches[0], 24, 24, dev)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"{smi}; stages of {[len(s.trees) for s in stages]} stumps, windows reaching each "
          f"stage of superbatch 0: {reach}")
    print(report(rows))
    for sizes, ms in sweep.items():
        print(f"hand-off sweep, stages of {list(sizes)} stumps, superbatch 0: " + ", ".join(
            f"{c} alive {v:.4f} ms" for c, v in ms.items()))
    for line in tile_report(24, 24):
        print(line)
    for name, regs, st, ld in _build.kernel_resources("mine.cu"):
        print(f"ptxas {name}: {regs} registers, spills {st} B stored, {ld} B loaded")


if __name__ == "__main__":
    main()
