"""Times the dense miner's tile kernel (``csrc/mine.cu``) with parts of its
design changed or taken out, to show where its time goes:

    python3 -m cascadeclassifier_tpu_torch.utils.tune_mine [--superbatches N]

Needs a CUDA device and nvcc. Builds the source once per variant below
(each a text substitution in a copy of the source, under
``_build/tune_mine/``, all nvcc runs started together; a variant may also
set the tile shapes ``train/mine.py`` packs for), then times each on
``utils/time_mine.py``'s superbatches of (s)'s backgrounds at 24x24 Haar
BASIC, under 3 stages of 2, 2 and 4 stumps and under 5 stages of 3, 6, 12,
24 and 48 (CUDA events, the mean of 20 launches after one), and prints each
variant's ptxas registers and spills, its tile, shared bytes and CTAs an
SM. A variant that takes work out gives other masks (``same False``); only
its time is read.

  threads128    128 threads a CTA, 16 x 4 windows a tile
  tile8x4       8 x 4 windows a tile, 128 threads a CTA, 6 CTAs an SM
  tile16x8      16 x 8 windows a tile (1 CTA an SM: its shared memory)
  cols4         4 pixel columns a lane at once instead of 8
  ldg           the gathers through the read-only data cache (__ldg)
  run1          the integral's loads one at a time, each after the last store
  no_squares    no column sums of squares (the windows' sums of squares)
  axis64        the axis tables in 64-bit division throughout
  no_pixels     no pixel build (the tile's shared memory as it is)
  no_integrals  no integrals
  no_walk       no stages: the build and the norm factor only
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.train import mine

CTA_SHARED = 233472  # an SM's shared memory, of which each CTA reserves 1 KB
# name: (text substitutions, tile shapes packed for, CTAs an SM the budget allows)
VARIANTS = {
    "default": ([], None, None),
    "threads128": ([("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")], None,
                   None),
    "tile8x4": ([("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 6;"),
                 ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")], ((8, 4),),
                6),
    "tile16x8": ([("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")],
                 ((16, 8),), 2),
    "cols4": ([("constexpr int kCols8 = 8;", "constexpr int kCols8 = 4;")], None, None),
    "axis64": ([("if ((2LL * (d > dsz ? d : dsz) + 1) * ssz + 256LL * dsz < 0x7fffffffLL)",
                 "if (false)")], None, None),
    "no_pixels": ([("for (int cb = 0; cb < pwe; cb += 32 * kCols8) {",
                    "for (int cb = 0; cb < (tid < 0 ? pwe : 0); cb += 32 * kCols8) {")], None,
                  None),
    "ldg": ([("          const int v0 = (256 - wy) * p0[0] + wy * p1[0];\n"
              "          const int v1 = (256 - wy) * p0[1] + wy * p1[1];",
              "          const int v0 = (256 - wy) * __ldg(p0) + wy * __ldg(p1);\n"
              "          const int v1 = (256 - wy) * __ldg(p0 + 1) + wy * __ldg(p1 + 1);")],
            None, None),
    "run1": ([("constexpr int kRun = 8;", "constexpr int kRun = 1;")], None, None),
    "no_squares": ([("    for (int wr = 0; wr < nrow; ++wr) {",
                     "    for (int wr = 0; wr < (tid < 0 ? nrow : 0); ++wr) {")],
                   None, None),
    "no_integrals": ([("  integral(S, pix, L.pw, P, phe, pwe, carry, tid);",
                       "  if (tid < 0) integral(S, pix, L.pw, P, phe, pwe, carry, tid);")],
                     None, None),
    "no_walk": ([("  while (si < tr.n_stages) {", "  while (tid < 0 && si < tr.n_stages) {")], None,
                None),
}
REPS = 20
OUT = os.path.join(_build.BUILD_DIR, "tune_mine")


def build_variants(names) -> dict:
    """{name: (library, ptxas resources)}, the nvcc runs in parallel."""
    with open(os.path.join(_build.CSRC_DIR, "mine.cu")) as f:
        base = f.read()
    os.makedirs(OUT, exist_ok=True)
    started = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name][0]:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in mine.cu")
            src = src.replace(old, new)
        cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o", so]
        started[name] = cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), so
    out = {}
    for name, (cmd, proc, so) in started.items():
        log = proc.communicate()[0]
        _build._raise_on_failure(cmd, proc.returncode, log)
        lib = ctypes.CDLL(so)
        for fn in ("cct_mine", "cct_mine_info"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = lib, [r for r in _build.ptxas_resources(log) if "tile_kernel" in r[0]]
    return out


def packed_for(name: str, levels, dev):
    """The superbatch packed for the variant's tile shapes."""
    _subs, shapes, blocks = VARIANTS[name]
    saved = mine.TILE_CANDIDATES, mine.TILE_BUDGET
    try:
        if shapes is not None:
            mine.TILE_CANDIDATES = shapes
            mine.TILE_BUDGET = CTA_SHARED // blocks - 1024
        mine.tile_shape.cache_clear()
        return mine.pack_levels(levels, 24, 24, dev)
    finally:
        mine.TILE_CANDIDATES, mine.TILE_BUDGET = saved
        mine.tile_shape.cache_clear()


def time_variant(lib, packed, feats, trees) -> tuple:
    """(mean launch ms over REPS by CUDA events, the mask)."""
    out = torch.empty(packed.n, dtype=torch.uint8, device=packed.table.device)
    args = mine.tile_args(packed, feats, trees, 24, 24, out)

    def run():
        _build.check(lib.cct_mine(*args), "cct_mine")

    run()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS, out.clone()


def main():
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator
    from cascadeclassifier_tpu_torch.utils import time_mine

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--superbatches", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_mine needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    names = ["default"] + [n for n in args.variants.split(",") if n != "default"]
    libs = build_variants(names)
    folder = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "_time_mine")
    try:
        bg = time_mine.write_backgrounds(folder)
        batches = time_mine.superbatches(NegReader(bg, 24, 24, lazy=True), args.superbatches)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    ev = HaarTrainEvaluator(haar_catalog(24, 24, "BASIC"), device=dev)
    cascades = [time_mine.synthetic_stages(ev, batches[0], 24, 24),
                time_mine.synthetic_stages(ev, batches[0], 24, 24, seed=1,
                                           sizes=(3, 6, 12, 24, 48), pass_rate=0.5)]
    print(f"{smi}; {len(batches)} superbatches of {[sum(len(lv[1]) for lv in b) for b in batches]}"
          f" windows, 24x24 Haar BASIC")
    for stages in cascades:
        used = sorted({int(t.feature_idx[0]) for s in stages for t in s.trees})
        feats = mine.features_of(ev, used)
        trees = mine.tree_table(stages, used, False, dev)
        ref = None
        for name in names:
            lib, res = libs[name]
            ms, masks = [], []
            for levels in batches:
                packed = packed_for(name, levels, dev)
                t, m = time_variant(lib, packed, feats, trees)
                ms.append(t)
                masks.append(m)
            if ref is None:
                ref = masks
            same = all(torch.equal(a, b) for a, b in zip(masks, ref))
            packed = packed_for(name, batches[0], dev)
            shape = packed.shapes[mine.KIND_HAAR]
            nbytes, ctas = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(lib.cct_mine_info(24, 24, mine.KIND_HAAR, *shape, ctypes.byref(nbytes),
                                           ctypes.byref(ctas)), "cct_mine_info")
            regs = {k: r[1:] for r in res for k, kind in
                    (("haar", "ILi0E"), ("tilted", "ILi1E"), ("lbp", "ILi2E")) if kind in r[0]}
            print(f"stages {[len(s.trees) for s in stages]} {name:13s} "
                  f"{float(np.mean(ms)):.4f} ms ({', '.join(f'{t:.4f}' for t in ms)}), "
                  f"same {same}, tile {shape[0]}x{shape[1]} ({packed.tiles[0]} CTAs), "
                  f"{nbytes.value} shared bytes, {ctas.value} CTAs an SM, ptxas (registers, "
                  f"spill stores, loads) {regs}", flush=True)


if __name__ == "__main__":
    main()
