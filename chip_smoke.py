"""Smoke run of the PyTorch/CUDA port on one GPU at 1080p.

    python3 chip_smoke.py

Drives cascadeclassifier_tpu_torch's detection paths through
TorchDetector on cuda:0, on 1920x1080 synthetic frames at scaleFactor
1.1, and checks them. The frontal-face path (haarcascade_frontalface_alt
.xml, 22 upright stages, engine "fused") on the plain vertical stack
(pack_band=False):

  (a) build     compile the CUDA kernels from csrc/ (fifteen sources), one nvcc per
                source, all started together (seconds), and the host library
                (csrc/cctpu_io.cpp, g++) that groups every frame's rects
  (b) integral  kernel integral vs its plain twin on frame 0's canvas, as
                uint8 (the fused engine's input) and as int32 (the same
                values; the stage engine's input)
  (c) front     kernel front vs its twin over stages 1..n_dense-1, on the
                ystep-2 and ystep-1 rows separately; survivors > 0
  (d) patchify  kernel patchify vs its twin on the front's survivors, at
                a capacity equal to and larger than the live count
  (e) e2e       frames 0-3 through the kernels (integral, prep, front,
                patchify) equal the twin path on the card; frames 0 and 1
                equal the committed OpenCV golden at minNeighbors 3 and 0;
                every kernel launched
  (f) timing    frames/s over 8 frames after a warm-up, phase table

The upper-body path (haarcascade_upperbody.xml, 30 stages with tilted
features, engine "pallas"):

  (g) tilted    kernel tilted vs its twin on frame 0's canvas, at the
                engine's pad and at pads too small to be exact
  (h) stage     kernel integral vs its twin on the upper body's int32
                canvas and as uint8; kernel stage vs its twin over stages
                0-29 (alive and stage 0's pass mask), and over the chunk 1-29
  (i) e2e       frames 0 and 1 through the kernels equal the twin path
                and the committed OpenCV golden at minNeighbors 3 and 0;
                tilted and stage launched
  (j) timing    frames/s over 8 frames after a warm-up, phase table

The frontal face again on the shelf-packed plan (pack_band=True, the
fused engine's default), with the dense front and with the packed front
(packed_front=True):

  (k) plan      both canvases; kernel integral vs its twin on the
                shelf-packed canvas, as uint8 and as int32
  (l) packed    the live-block list vs the list built on the CPU; kernel
                packed_front vs its twin and vs kernel front over stages
                1..n_dense-1 on frame 0's prep mask; survivors and the
                live-block fraction
  (m) e2e       per front: frames 0-3 equal the twin path and map to the
                plain stack's rects, frames 0 and 1 equal the OpenCV
                golden at minNeighbors 3 and 0, and packed_front (or
                front) alone was launched
  (n) timing    per front: frames/s and phase table; both front kernels
                and the list build timed on the shelf-packed canvas; the
                prep kernel at the benchmark's shape (a 4K frame, the
                shelf-packed plan, f64 sums) vs its twin bit for bit, one
                launch a frame, timed

The tiled kernels, the tilted kernel and the integral kernel at their
edges:

  (o) edges     kernels front and stage vs their twins on small canvases
                whose window grid is one less than, equal to and one more
                than two tiles each way, with every tile dead, every
                window alive, one window alive in the last row and column
                and a checkerboard: front over stages [1, 8), [3, 5) and
                [4, 4); stage over [0, 30), [0, 1), [1, 30) and [5, 9) of
                the upper body and over [0, 22) of the frontal face with
                the integral canvas passed as the tilted one. Kernel
                packed_front vs its twin on the same grids and one a
                column wider than a listed block, each mask with six
                block lists (the live blocks, every block, one short,
                nblk 0, entries outside the grid, reverse order), and vs
                kernel front where every block is listed. Kernel tilted
                vs its twin on canvases with runs of 1, 2 and 3 rows, runs
                around a chunk of rows, a top in the last row and row 0
                no top, at widths around its strips and pads 0, 3, exact
                and 500. Kernel integral vs its twin on random canvases of
                heights 1, a band less one, a band, a band and one, three
                bands and five rows, by widths 1, 31, 32, 33, 1921, 3841
                and one pass of its apply launch and one more, as uint8
                and as int32 up to 2^20 (both sums wrap). Each kernel
                twice on frame 0's 1080p inputs with equal outputs, and
                the front's stages through the stage kernel (the same tile
                kernel with its dense pass compiled in), timed. Then the
                tile kernel's other policies on the same shapes and masks
                (utils/edges.py: policy_edge_cases), f32 and f64: front and
                stage on the frontal face and the upper body (stage) in
                f64, on a hand-built knife-edge stump cascade whose f32 and
                f64 stage sums fall on both sides of its threshold, Haar
                node trees (alt2; eye_tree cut to 4 stages, tilted, 3
                nodes, stage only), LBP stumps and a hand-built LBP cascade
                of 2-node trees; packed_front in f64 on its edge lists.
                Kernel cat_split vs its plain version in its three
                policies on code blocks of 31, 32, 33, 1023, 1024, 1025,
                32767, 32768 and 32769 samples (a uniform feature with a
                window of one code, 4 codes, one category, skewed codes)
                and on skewed 3072-sample blocks of one feature less than,
                as many as and one more than a launch's warps
                (utils/edges.py: cat_split_edge_cases). Kernel
                split_scan_class_gather vs its plain version on the CPU in
                both policies and both layouts: blocks of 1, 15, 16, 17,
                255-257 and 4096-4097 samples, 1 and 33 features, sample
                counts on both sides of its shared-memory table, every
                sample masked out, one class only, every value equal, ±0.0,
                a kept position carried over a fully masked chunk, exact
                ties across a chunk's edge (utils/edges.py:
                class_split_edge_cases)

The f64 stage sums (exact=True, the detector's default; every phase above
runs exact=False):

  (p) exact     kernels front and packed_front (frontal face, plain stack
                and shelf-packed) and stage (upper body) in f64 vs their
                twins at 1080p; frames 0-3 (frontal, plain stack) and 0-1
                (shelf-packed with the packed front; upper body) equal the
                twin path, frames 0 and 1 equal both goldens at
                minNeighbors 3 and 0; f64 kernel times beside the f32 ones

The node-tree and LBP cascades, every stage in the tile kernel:

  (q) deep      haarcascade_frontalface_alt2.xml (20 stages, 1 047 trees of
                2 nodes, upright): kernel stage (node-tree policy) vs its
                twin over every stage, kernel front vs its twin over stages
                1..19 of the fused engine's prep mask, both in f32 and f64;
                engines "auto" ("pallas") and "fused" at exact True and
                False: frames 0 and 1 equal data/smoke_golden_alt2_1080p
                .json at minNeighbors 3 and 0; timing and phase table
  (r) lbp       lbpcascade_frontalface.xml (20 stages, 139 LBP stumps,
                24x24), the same checks against data/smoke_golden_lbp_1080p
                .json

The trainer (24x24 windows, Haar BASIC's 162 336 features, GAB stumps,
weak_count 100, minHitRate 0.995, maxFalseAlarm 0.5, the CLI's 1024 MB
budgets):

  (s) training  1200 positives (utils/train_data.py: a ring and a disc on
                a grey card, jittered) in a .vec and 20 clutter frames of
                1920x1080 with near-miss decoys as PGM, all numpy. Check 1:
                stage 0's real blocks (1000 positives + 2000 negatives,
                5 blocks) at two boosting iterations: split_scan_gather on
                the resident (N, B) sort outputs and on a fresh sort's
                (B, N) outputs, and the array form split_scan on the fast
                and the generic callers' inputs (equal), all bit for bit
                equal to the plain version on the CPU. Check 2: the first
                3 stages of the CLI's 20-stage run (its leaf false-alarm
                target) at 1000 + 2000 samples on the card (the budgets
                keep 2 value and 0 index blocks: every block is sorted
                anew), each stage's first mining superbatch's accept masks
                equal to the CPU's, per-stage times, the phase totals and
                train_stage s a tree; split_scan_gather launched, the
                array form split_scan not at all;
                params.xml, stage0-2.xml and cascade.xml written and a new
                trainer resumes from them. Check 3: stage 0 at 200
                + 400 samples on the card and on the CPU, stage0.xml
                byte-identical. At 75x32, where the f32 product's partial
                sums may pass 2^24, the count of values that differ
                between the card and the CPU is printed (measured, not
                held). Check 4: cascade.xml reads back to the
                trained model, and both detector engines give the twin
                path's raw windows on a 1080p frame with planted marks.
                Check 5: a hand-built cascade of stumps over tilted and
                upright Haar ALL features through predict_levels on
                40 000 mining windows, the card's masks equal to the CPU's.
                The miner (train/mine.py, csrc/mine.cu) runs every mining
                superbatch of a stump cascade as one launch: check 2
                holds kernel mine's launches equal to its superbatches,
                and each stage's fill_negatives is printed net of the
                CPU's check inside it ((t), (u) and (v) too; (u)'s depth-2
                trees and (v)'s HOG take the gather path and no launch)

Right after (s), on its data:

  (z) mine      the dense miner's tile kernel. Check 1: kernel mine equal
                to its plain version mine_ref on the card on
                utils/edges.py's mine_edge_cases (22 cases: nf = 0
                windows, tree thresholds equal to window values, the
                level's last row and column, a scale-1 lazy level, a
                source 2 pixels wide, eager levels, a level of one window
                and an empty one, stage sets of 1 to 301 trees across the
                scan's blocks of 16 and 256, -0.0 leaves, LBP all-bits
                subsets and codes, tilted features touching the window's
                edge; the tiles' edges: runs starting and ending inside
                tiles, a level inside one tile, a one-window last tile,
                nx = 1, a 13x11 window, tilted features on tile borders),
                one launch a case; the replaced design (a warp a window,
                mine_warp) equal too. Check 2: 10 superbatches of 131 072
                windows of (s)'s backgrounds under (s)'s 3 trained stages
                through mine, mine_warp, mine_ref and the library
                composite (utils/time_mine.py), each mask of both kernels
                equal to mine_ref's: ms a superbatch (levels to host
                mask; the kernel first with the new sources' upload, then
                with the sources on the card in turns with mine_warp),
                levels, launches and windows a superbatch, windows/s, the
                kernel path apart (pack_levels alone, the launch alone in
                CUDA events for both kernels, the fetch), the windows
                reaching each stage, the bound (each covered level pixel
                once, integer work at the INT32 rate: covered_pixels,
                mine_ops, mixed_bound); ptxas's registers and spills of
                both kernels' three kinds, the tile kernel's tile, shared
                bytes a CTA and CTAs an SM for each kind

LBP and the other boost types, on (s)'s data:

  (t) boost     1000 positives + 2000 negatives. Check 1: stage 0's LBP
      types     code block (8464 features, 24x24) at two boosting
                iterations through cat_split in its three policies
                (regression, misclassification, Gini), bit for bit equal
                to the plain version on the card (and on the CPU); the
                kernel (regression) on uniform random codes and on one
                code a feature of the same shape, bit for bit too, timed
                with the real block beside the library composite;
                ptxas's registers and spills for cat_split. Check
                2: the first 3 stages of a 20-stage LBP run (GAB stumps,
                weak_count 100, minHitRate 0.995, maxFalseAlarm 0.5) on
                the card, each stage's first mining superbatch equal to
                the CPU's, per-stage times by phase and trees a stage,
                cat_split launched; stage 0 trained on the CPU too,
                stage0.xml byte-identical. Check 3: stage 0's Haar blocks
                at two DAB iterations through split_scan_class_gather
                (misclassification and Gini) equal to its plain version;
                the design it replaces (split_scan.cu with its two-class
                quality put back, utils/tune_split_class.py) on the same
                block, equal
                too, both timed on the sort's (B, N) outputs and on the
                resident (N, B) block; the kernel's ptxas registers and
                spills and its resident CTAs an SM. Check 4: a DAB stage
                at 200 + 400 samples on the card and on the CPU,
                stage0.xml byte-identical, split_scan_class_gather
                launched

Deep weak trees and HOG, on (s)'s data:

  (u) deep      Check 1: the first 3 stages of a 20-stage Haar BASIC GAB
                run at max_depth 2 (weak_count 100, minHitRate 0.995,
                maxFalseAlarm 0.5, 1000 + 2000 samples) on the card, each
                stage's first mining superbatch (the node walk) equal to
                the CPU's, per-stage times by phase, split_scan_gather's
                launches a tree. Check 2: stage 0 at depth 2 on the card
                and on the CPU, stage0.xml byte-identical, for Haar GAB
                and DAB at 200 + 400 samples and LBP GAB at 1000 + 2000:
                split_scan_gather, split_scan_class_gather and cat_split
                each run under node masks that are no tree root's
  (v) hog       Check 1: hog_hist and hog_eval (every variable) on stage
                0's 3072 samples at 24x24 and resized to 32x32 (cells of
                16), and on utils/edges.py's HOG windows (flat, step edges,
                ±255 at the borders, the bin edges, batches of 1, 3 and 5
                windows; 181x256 and 256x181 too; hog_eval also on unsorted,
                repeated, single and shuffled variable lists), bit for bit
                equal to their plain versions (hog_hist to the CPU's too).
                Check 2:
                the first 3 stages of a 20-stage 24x24 HOG GAB run on the
                card with the checks of (u), and stage 0 card against CPU
                byte for byte. Check 3: the trained cascade detects on
                synth_frame(0) at 1080p (sf 1.1, minNeighbors 3) on the
                card, its raw candidates and rects equal to the
                plain-version path's on the card; windows, ms a frame and
                the phase split (every scope, and the time outside them).
                Check 4: both kernels on the detector's first batch (8 192
                windows at 24x24, the cascade's used variables) equal to
                their plain versions; both timed there and at 32x32 too,
                and their device time from torch.profiler at 24x24
                (hog_eval's plan and gather launches apart) and on the
                detector's batch (hog_eval's direct gather)

Multi-device training and the tools, on (s)'s data (parallel/, tools/):

  (w) mesh      Check 1: sharded_ordered_best_split over 4 in-process
                shards on cuda:0 (8192 rows each) equals split_scan_gather
                + best_of_block over stage 0's first block (32768 features
                x 3072 samples) bit for bit, at uniform and at reweighted
                weights, the kernel launched once a shard; the sharded
                search timed. Check 2: stage 0 at 1000 + 2000 samples with
                CascadeTrainer(mesh=4 shards on cuda:0) writes the
                unsharded run's stage0.xml byte for byte, for Haar GAB
                (split_scan_gather), LBP GAB (cat_split) and Haar DAB at
                depth 2 (split_scan_class_gather under node masks); each
                kernel's launches; s/stage sharded and unsharded beside
                the card's name and power limit (a record: 4 shards on one
                card only add launches). Check 3: two processes on cuda:0
                joined by gloo (parallel/dryrun.py --what train) return the
                one-process stage; rank 0 writes its stage0.xml byte for
                byte, rank 1 writes nothing. Check 4: a one-rank NCCL group
                combines CUDA records into check 1's split. Check 5:
                dryrun_multichip(8) with its 8 shards on the card
  (x) tools     Check 1: torch-traincascade's main trains 2 stages on the
                card (-maxFalseAlarmRate 0.1: with the default 0.5 the
                leaf target 0.5^2 ends the run at stage 1's first
                windows); its cascade.xml loads, and make_detector's rects on
                a 1080p clutter frame equal the plain-version path's.
                Check 2: torch-detect's main on synth frame 0 (frontal
                face, sf 1.1, minNeighbors 3, f64 sums) prints the rects
                of data/smoke_golden_1080p.json; a HOG cascade goes to
                HOGDetector through hog_hist and hog_eval. Check 3:
                utils/profiling.py's trace() around one frame writes a
                Chrome trace holding the frame's detect.frame span and the
                front's tile_kernel

The host library (csrc/cctpu_io.cpp: grouping, the .vec codec, the
negative-window miner; C++ and its standard library, built with g++ in
(a); every detection phase above grouped through it):

  (y) native    Check 1: g++'s version, the library's build seconds and
                its place under the port's _build/. Check 2: its grouping
                equals the numpy grouping, rects and order, on
                utils/time_grouping.py's detection-like sets of 64 to 8192
                rects at group thresholds 1 and 3, and on the frontal
                face's raw rects of frames 0-3 (plain stack and
                shelf-packed plan) at 1 and 3; native, dense and k-d
                grouping ms by size from 64 to 16384 rects; every timed
                detection phase's "group" ms, and its group step re-timed
                on the same raw windows through group_rectangles and
                through the numpy grouping side by side. Check 3: its
                .vec writer and reader against data/vec.py byte for byte;
                its miner equal to NegReader(lazy=False).take_batch over
                2000 windows of a background list the phase writes (PGM
                and PNG files of every PNG filter, one smaller than the
                window, one missing), at two window shapes, both timed
                (the miner createsamples -img -bg takes its windows from)

and last, per kernel at its path's shapes: time against its twin, the
least time the card could take (bytes over 3.35 TB/s or operations over
67 TFLOP/s, the H100 SXM's published rates), and one PyTorch call that
computes the same function where one exists (for the integral, which has
none, the int32 input's time and the chained torch.cumsum composite's
beside it; for split_scan_gather, its time on a resident block and, on the
same block, the trainer's path before and after the gathered form: the
transposes, the gathers and the array form, against the tables and the
gathered form); the new policies' operations count the nodes each window
visits on its path (the twin's path counts, dense.window_node_visits);
then each path traced with
torch.profiler over 4 frames (device time, idle share, launches, host
synchronizations: the packed front's may not exceed the dense front's).
Exits non-zero on any mismatch, and without CUDA. The last line is
{"ok": true, "device": ...}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cascadeclassifier_tpu_torch.utils.time_hog import cuda_ms, device_ms

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM, float64 outside the tensor cores
INT32_OPS_PER_S = F32_OPS_PER_S / 2  # 64 INT32 lanes an SM against 128 FP32; an IMAD counts 2


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def bound(nbytes: float, nops: float, rate: float = F32_OPS_PER_S):
    """(least ms, what bounds it): each input read and each output written
    once over the memory rate, or the operations over their rate (f32 by
    default)."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, nops / rate * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def stage_ops(st) -> int:
    """Arithmetic operations of one window through one stump-Haar stage:
    per tree with k rects of nonzero weight, 3k integer corner adds, k
    conversions, k multiplies, k−1 adds, then ·inv_nf, the compare and
    the leaf add (6k + 3); plus the stage compare."""
    k = (st.weights != 0).sum(axis=1)
    return int((6 * k + 3).sum()) + 1


def cascade_ops(cas, s0: int, evaluated) -> int:
    """Operations of a stage run in which evaluated[i] windows went
    through stage s0 + i."""
    return sum(int(n) * stage_ops(cas.stages[s0 + i]) for i, n in enumerate(evaluated))


LBP_NODE_OPS = 47  # 27 cell-sum adds, 8 compares, 7 ors, 4 subset shifts and masks, the select


def walk_ops(cas, sum2d, tilt2d, inv_nf, out_w, evaluated) -> int:
    """Operations of a stage run in which the windows of flat indices
    evaluated[si] went through stage si, counting the nodes each window
    visits on its path (dense.window_node_visits): a Haar node of k
    weighted rects 6k + 2 (stage_ops less the leaf add), an LBP node
    LBP_NODE_OPS; then one leaf add a tree and the stage compare."""
    from cascadeclassifier_tpu_torch.detect.dense import window_node_visits

    total = 0
    for si, idx in evaluated.items():
        st = cas.stages[si]
        inv = None if inv_nf is None else inv_nf.reshape(-1)[idx]
        visits = window_node_visits(sum2d, tilt2d if cas.has_tilted else None, st, idx, out_w,
                                    inv, cas.is_lbp)
        total += sum(v * (LBP_NODE_OPS if cas.is_lbp else 6 * k + 2) for k, v in visits.items())
        total += int(idx.numel()) * (st.ntrees + 1)
    return total


def gpu_info() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def flat_alive(mask):
    return torch.nonzero(mask.reshape(-1)).squeeze(1)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
    from cascadeclassifier_tpu_torch.detect.detector import (
        PackedCascade,
        TorchDetector,
        build_pixel_canvas,
        positions_to_rects,
    )
    from cascadeclassifier_tpu_torch.detect.front import front
    from cascadeclassifier_tpu_torch.detect.integral import integral
    from cascadeclassifier_tpu_torch.detect.packed_front import (
        listed_windows,
        live_block_list,
        packed_front,
    )
    from cascadeclassifier_tpu_torch.detect.patchify import patchify
    from cascadeclassifier_tpu_torch.detect.stage import stage
    from cascadeclassifier_tpu_torch.detect.tilted import tilted
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
    from cascadeclassifier_tpu_torch.utils.edges import (
        CAT_NS,
        FRONT_RANGES,
        INTEGRAL_HEIGHTS,
        INTEGRAL_WIDTHS,
        STAGE_RANGES,
        cat_split_edge_mismatches,
        class_split_edge_mismatches,
        edge_mismatches,
        integral_edge_mismatches,
        packed_edge_mismatches,
        policy_edge_cases,
        policy_ranges,
        tilted_edge_mismatches,
    )
    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    dev = torch.device("cuda:0")
    data = os.path.join(HERE, "cascadeclassifier_tpu_torch", "data")
    model = read_cascade_xml(os.path.join(data, "haarcascade_frontalface_alt.xml"))
    with open(os.path.join(data, "smoke_golden_1080p.json")) as f:
        golden = json.load(f)
    H, W, SF = golden["height"], golden["width"], golden["scale_factor"]
    smi = gpu_info()

    # (a) build
    t0 = time.perf_counter()
    _build.lib()
    print(f"(a) build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)} -> sm_90a)", flush=True)
    t0 = time.perf_counter()
    _build.build_host()
    host_build_s = time.perf_counter() - t0
    print(f"(a) build: {host_build_s:.1f} s ({_build.HOST_SOURCE} -> g++)", flush=True)

    det = TorchDetector(model, exact=False, device=dev, pack_band=False)
    ref = TorchDetector(model, exact=False, device=dev, impl="ref", pack_band=False)
    check(det.engine_name == "fused", f"frontal face routed to {det.engine_name}")
    eng, cas = det.engine, det.packed
    frames = [synth_frame(k, H, W) for k in range(8)]
    for g in golden["frames"]:
        sha = hashlib.sha256(frames[g["k"]].tobytes()).hexdigest()
        check(sha == g["sha256"], f"synth frame {g['k']} differs from the golden's")
    plan = det.plan_for(W, H, SF, None, None)
    img0 = torch.from_numpy(frames[0]).to(dev)
    levels = eng._plan_tensors(plan)[0]

    def max_abs_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    errs, launches, timed, work = {}, {}, {}, {}
    timed_extra = {}  # kernel name -> {key: fn}: further times beside the kernel's

    def integral_err(px_any, label: str):
        """integral on px_any as uint8 and as int32 (the same values) vs
        the twin, exactly → (kernel's sum, sq on the uint8 input, the max
        abs error)."""
        err, out = 0, None
        for dtype in (torch.uint8, torch.int32):
            x = px_any.to(dtype)
            got, want = integral(x), integral(x, impl="ref")
            torch.cuda.synchronize()
            err = max(err, *(max_abs_err(g, r) for g, r in zip(got, want)))
            check(all(torch.equal(g, r) for g, r in zip(got, want)),
                  f"integral kernel != twin on the {label} canvas as {dtype}")
            out = got if out is None else out
        return out[0], out[1], err

    # (b) integral
    px = build_pixel_canvas(img0, plan, levels, torch.uint8)  # as Engine.detect builds it
    check(torch.equal(px.int(), build_pixel_canvas(img0, plan, levels)),
          "the uint8 pixel canvas differs from the int32 one")
    s_k, q_k, errs["integral"] = integral_err(px, "plain-stack")
    print(f"(b) integral: canvas {tuple(px.shape)}, uint8 and int32, sum and sq equal to "
          f"the twin (tolerance: exact, max_abs_err {errs['integral']})", flush=True)

    # (c) front
    inv_nf, alive0 = eng.prep(s_k, q_k, plan)
    f_k = front(s_k, inv_nf, alive0, cas, 1, eng.n_dense)
    f_r = front(s_k, inv_nf, alive0, cas, 1, eng.n_dense, impl="ref")
    torch.cuda.synchronize()
    errs["front"] = max_abs_err(f_k, f_r)
    step2 = torch.as_tensor(plan.row_step2[: plan.out_h], device=dev)
    for name, rows in (("ystep-2", step2), ("ystep-1", ~step2)):
        check(torch.equal(f_k[rows], f_r[rows]), f"front kernel != twin on {name} rows")
        print(f"(c) front {name} rows: {int(f_k[rows].sum())} survivors, equal to the twin "
              "(tolerance: exact)", flush=True)
    n_prep, n_front = int(alive0.sum()), int(f_k.sum())
    print(f"(c) survivors: {n_prep} after prep, {n_front} after stages 1..{eng.n_dense - 1}",
          flush=True)
    check(n_prep > 0 and n_front > 0, "no survivors after prep or front")

    # (d) patchify
    idx = torch.nonzero(f_k.reshape(-1)).squeeze(1)
    r = (idx // plan.out_w).to(torch.int32)
    c = (idx % plan.out_w).to(torch.int32)
    extra = 37
    r_big = torch.cat([r, torch.zeros(extra, dtype=torch.int32, device=dev)])
    c_big = torch.cat([c, torch.zeros(extra, dtype=torch.int32, device=dev)])
    for rr, cc in ((r, c), (r_big, c_big)):
        p_k = patchify(s_k, rr, cc, n_front, cas.win_w, cas.win_h)
        p_r = patchify(s_k, rr, cc, n_front, cas.win_w, cas.win_h, impl="ref")
        torch.cuda.synchronize()
        errs["patchify"] = max(errs.get("patchify", 0), max_abs_err(p_k, p_r))
        check(torch.equal(p_k, p_r), f"patchify kernel != twin at capacity {rr.numel()}")
        check(not p_k[n_front:].any(), "patchify rows past cnt are not zero")
    print(f"(d) patchify: {n_front} windows x {p_k.shape[1]} cells, capacity "
          f"{n_front} and {n_front + extra} equal to the twin (tolerance: exact)", flush=True)

    # (e) end to end: kernel path (counted) vs twin path, and the golden
    _build.LAUNCHES.clear()
    got = [det.raw_windows(frames[k], SF)[1] for k in range(4)]
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for name in ("integral", "prep", "front", "patchify"):
        check(counts.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
        launches[name] = counts[name]
    for k in range(4):
        want = ref.raw_windows(frames[k], SF)[1]
        check(np.array_equal(got[k], want), f"frame {k}: kernel path != twin path")
    for g in golden["frames"]:
        for mn in (3, 0):
            ours = sorted(map(list, TorchDetector.group(plan, got[g["k"]], mn).tolist()))
            check(ours == g[f"rects_mn{mn}"],
                  f"frame {g['k']} minNeighbors {mn}: {len(ours)} rects vs "
                  f"{len(g[f'rects_mn{mn}'])} in the OpenCV golden")
    print(f"(e) e2e: frames 0-3 raw windows {[len(x) for x in got]} equal to the twin path; "
          f"frames 0,1 equal the OpenCV golden at minNeighbors 3 and 0; "
          f"launches {counts}", flush=True)

    # (f) timing
    detection_timing("f", det, frames, SF, smi)

    ncells = n_front
    hw = px.numel()
    n_win = plan.out_h * plan.out_w
    front_eval = [int(alive0.sum())] + [
        int(front(s_k, inv_nf, alive0, cas, 1, s).sum()) for s in range(2, eng.n_dense)
    ]
    flat = ((r.long() * plan.canvas_w + c.long())[:, None]
            + torch.arange(cas.win_h + 1, device=dev).repeat_interleave(cas.win_w + 1)
            * plan.canvas_w
            + torch.arange(cas.win_w + 1, device=dev).repeat(cas.win_h + 1)).reshape(-1)
    timed["integral"] = (lambda: integral(px), lambda: integral(px, impl="ref"), None, 3)
    px32 = px.int()

    def composite():
        x = px.int()
        return tuple(torch.cumsum(torch.cumsum(v, 1, dtype=torch.int32), 0, dtype=torch.int32)
                     for v in (x, x * x))

    check(all(torch.equal(g, r) for g, r in zip(composite(), (s_k, q_k))),
          "the cumsum composite != the integral")
    integral_extra = {"int32_ms": cuda_ms(lambda: integral(px32), 20),
                      "int32_bound_ms": bound(12 * px.numel(), 5 * px.numel())[0],
                      "composite_ms": cuda_ms(composite, 20)}
    timed["front"] = (lambda: front(s_k, inv_nf, alive0, cas, 1, eng.n_dense),
                      lambda: front(s_k, inv_nf, alive0, cas, 1, eng.n_dense, impl="ref"),
                      None, 3)
    timed["patchify"] = (lambda: patchify(s_k, r, c, ncells, cas.win_w, cas.win_h),
                         lambda: patchify(s_k, r, c, ncells, cas.win_w, cas.win_h, impl="ref"),
                         lambda: s_k.reshape(-1)[flat], 3)
    # px read once, both int32 outputs written once
    work["integral"] = bound((px.element_size() + 8) * hw, 5 * hw)
    work["front"] = bound(4 * hw + 6 * n_win, cascade_ops(cas, 1, front_eval))
    work["patchify"] = bound(2 * 4 * flat.numel() + 2 * 4 * ncells, 0)

    # ------------------------------------------------------------------
    # the upper-body path: tilted features through the stage engine
    body = read_cascade_xml(os.path.join(data, "haarcascade_upperbody.xml"))
    with open(os.path.join(data, "smoke_golden_upperbody_1080p.json")) as f:
        golden_ub = json.load(f)
    check((golden_ub["height"], golden_ub["width"], golden_ub["scale_factor"]) == (H, W, SF),
          "the upper-body golden's geometry differs")
    for g in golden_ub["frames"]:
        sha = hashlib.sha256(frames[g["k"]].tobytes()).hexdigest()
        check(sha == g["sha256"], f"synth frame {g['k']} differs from the upper-body golden's")
    det_b = TorchDetector(body, exact=False, device=dev)
    ref_b = TorchDetector(body, exact=False, device=dev, impl="ref")
    check(det_b.engine_name == "pallas", f"upper body routed to {det_b.engine_name}")
    eng_b, cas_b = det_b.engine, det_b.packed
    n_st = len(cas_b.stages)
    plan_b = det_b.plan_for(W, H, SF, None, None)
    levels_b, grid_b = eng_b._walk_tensors(plan_b)[:2]
    pad = int(plan_b.scaled_h.max()) + 1

    # (g) tilted
    px_b = build_pixel_canvas(img0, plan_b, levels_b)
    t_k = tilted(px_b, plan_b.is_top, pad)
    t_r = tilted(px_b, plan_b.is_top, pad, impl="ref")
    torch.cuda.synchronize()
    errs["tilted"] = max_abs_err(t_k, t_r)
    check(torch.equal(t_k, t_r), "tilted kernel != twin")
    for small in (3, 0):  # too small to be exact: the twin's truncation has to come out too
        t_s = tilted(px_b, plan_b.is_top, small)
        t_sr = tilted(px_b, plan_b.is_top, small, impl="ref")
        torch.cuda.synchronize()
        errs["tilted"] = max(errs["tilted"], max_abs_err(t_s, t_sr))
        check(torch.equal(t_s, t_sr), f"tilted kernel != twin at pad {small}")
        check(not torch.equal(t_s, t_k), f"pad {small} changed nothing: the check is vacuous")
    print(f"(g) tilted: canvas {tuple(px_b.shape)}, {len(plan_b.scales)} blocks, equal to the "
          f"twin at pad {pad} and at pads 3 and 0 (tolerance: exact, max_abs_err "
          f"{errs['tilted']})", flush=True)

    # (h) stage
    sb, qb = integral(px_b)
    _, _, err = integral_err(px_b, "upper-body")
    errs["integral"] = max(errs["integral"], err)
    gate_b, inv_b = dense_variance_gate(sb, qb, cas_b.win_w, cas_b.win_h,
                                        plan_b.out_h, plan_b.out_w)
    alive_b = gate_b & grid_b
    a_k, p0_k = stage(sb, t_k, inv_b, alive_b, cas_b, 0, n_st)
    a_r, p0_r = stage(sb, t_k, inv_b, alive_b, cas_b, 0, n_st, impl="ref")
    torch.cuda.synchronize()
    errs["stage"] = max(max_abs_err(a_k, a_r), max_abs_err(p0_k, p0_r))
    check(torch.equal(a_k, a_r), "stage kernel != twin (alive, stages 0-29)")
    check(torch.equal(p0_k, p0_r), "stage kernel != twin (passed0)")
    a1 = alive_b & p0_k
    c_k, cp_k = stage(sb, t_k, inv_b, a1, cas_b, 1, n_st)
    c_r, cp_r = stage(sb, t_k, inv_b, a1, cas_b, 1, n_st, impl="ref")
    torch.cuda.synchronize()
    errs["stage"] = max(errs["stage"], max_abs_err(c_k, c_r))
    check(torch.equal(c_k, c_r) and torch.equal(cp_k, cp_r), "stage kernel != twin (1-29)")
    check(torch.equal(c_k, a_k) and not cp_k.any(), "stages 1-29 after stage 0 != stages 0-29")
    stage_eval = [plan_b.out_h * plan_b.out_w] + [
        int(stage(sb, t_k, inv_b, alive_b, cas_b, 0, s)[0].sum()) for s in range(1, n_st)
    ]
    n0, n_last = stage_eval[1], int(a_k.sum())
    print(f"(h) integral: upper-body canvas {tuple(px_b.shape)}, int32 and uint8, equal to "
          f"the twin (tolerance: exact, max_abs_err {err})", flush=True)
    print(f"(h) stage: alive and passed0 over stages 0-{n_st - 1}, and alive over the chunk "
          f"1-{n_st - 1}, equal to the twin (tolerance: exact); {int(alive_b.sum())} windows "
          f"in, {n0} after stage 0, {n_last} after stage {n_st - 1}", flush=True)
    check(n0 > 0, "no survivors after stage 0")

    # (i) end to end on the upper-body path
    _build.LAUNCHES.clear()
    got_b = {g["k"]: det_b.raw_windows(frames[g["k"]], SF)[1] for g in golden_ub["frames"]}
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for name in ("integral", "tilted", "stage"):
        check(counts.get(name, 0) > 0, f"kernel {name} was not launched on the upper-body path")
    check("front" not in counts and "packed_front" not in counts,
          "the upper-body path launched a front kernel")
    launches["tilted"], launches["stage"] = counts["tilted"], counts["stage"]
    for k, idx_k in got_b.items():
        check(np.array_equal(idx_k, ref_b.raw_windows(frames[k], SF)[1]),
              f"upper body frame {k}: kernel path != twin path")
    for g in golden_ub["frames"]:
        for mn in (3, 0):
            ours = sorted(map(list, TorchDetector.group(plan_b, got_b[g["k"]], mn).tolist()))
            check(ours == g[f"rects_mn{mn}"],
                  f"upper body frame {g['k']} minNeighbors {mn}: {len(ours)} rects vs "
                  f"{len(g[f'rects_mn{mn}'])} in the OpenCV golden")
    print(f"(i) e2e: upper-body frames 0,1 raw windows {[len(x) for x in got_b.values()]} "
          f"equal to the twin path and the OpenCV golden at minNeighbors 3 and 0 "
          f"({[len(g['rects_mn3']) for g in golden_ub['frames']]} and "
          f"{[len(g['rects_mn0']) for g in golden_ub['frames']]} rects); launches {counts}",
          flush=True)

    # (j) timing
    detection_timing("j", det_b, frames, SF, smi)
    timed["tilted"] = (lambda: tilted(px_b, plan_b.is_top, pad),
                       lambda: tilted(px_b, plan_b.is_top, pad, impl="ref"), None, 1)
    timed["stage"] = (lambda: stage(sb, t_k, inv_b, alive_b, cas_b, 0, n_st),
                      lambda: stage(sb, t_k, inv_b, alive_b, cas_b, 0, n_st, impl="ref"),
                      None, 1)
    # per canvas cell: two neighbours, T[y-2] and two pixels
    work["tilted"] = bound(2 * 4 * px_b.numel(), 5 * px_b.numel())
    work["stage"] = bound(2 * 4 * sb.numel() + 7 * plan_b.out_h * plan_b.out_w,
                          cascade_ops(cas_b, 0, stage_eval))
    tree_evals = [n * cas_b.stages[i].ntrees for i, n in enumerate(stage_eval)]
    print(f"(j) stage kernel's work on frame 0: {tree_evals[0]} tree evaluations in stage 0 "
          f"(every window), {sum(tree_evals[1:])} in stages 1-{n_st - 1} (the windows that "
          f"reach each stage)", flush=True)

    # ------------------------------------------------------------------
    # the frontal face on the shelf-packed plan: dense and packed front
    n_dense = eng.n_dense

    # (k) plan
    det_p = TorchDetector(model, exact=False, device=dev)
    check(det_p.pack_band, "the fused engine did not take the shelf-packed plan by default")
    plan_p = det_p.plan_for(W, H, SF, None, None)
    check(plan_p.packed, "pack_band=True gave a plain-stack plan")
    px_p = build_pixel_canvas(img0, plan_p, det_p.engine._plan_tensors(plan_p)[0], torch.uint8)
    sp_k, qp_k, err = integral_err(px_p, "shelf-packed")
    errs["integral"] = max(errs["integral"], err)
    shelf_ms = cuda_ms(lambda: integral(px_p), 20)
    print(f"(k) plan: shelf-packed canvas {plan_p.canvas_h} x {plan_p.canvas_w} "
          f"({px_p.numel()} cells) against the plain stack's {plan.canvas_h} x "
          f"{plan.canvas_w} ({px.numel()} cells); integral equal to the twin there, uint8 "
          f"and int32 (tolerance: exact, max_abs_err {err}); kernel integral on the uint8 "
          f"canvas {shelf_ms:.4f} ms, bound {bound(9 * px_p.numel(), 0)[0]:.4f} ms (bytes)",
          flush=True)

    # (l) packed front
    inv_p, alive_p = det_p.engine.prep(sp_k, qp_k, plan_p)
    blk, nblk = live_block_list(alive_p)
    blk_r, nblk_r = live_block_list(alive_p.cpu())
    check(torch.equal(blk.cpu(), blk_r) and torch.equal(nblk.cpu(), nblk_r),
          "live-block list on the card != the list built on the CPU")
    pf_k = packed_front(sp_k, inv_p, alive_p, blk, nblk, cas, 1, n_dense)
    pf_r = packed_front(sp_k, inv_p, alive_p, blk, nblk, cas, 1, n_dense, impl="ref")
    df_k = front(sp_k, inv_p, alive_p, cas, 1, n_dense)
    torch.cuda.synchronize()
    errs["packed_front"] = max(max_abs_err(pf_k, pf_r), max_abs_err(pf_k, df_k))
    check(torch.equal(pf_k, pf_r), "packed_front kernel != twin")
    check(torch.equal(pf_k, df_k), "packed_front kernel != front kernel on the same inputs")
    n_live, nb_cap = int(nblk[0]), blk.shape[0]
    n_prep_p, n_front_p = int(alive_p.sum()), int(pf_k.sum())
    n_listed = int(listed_windows(blk, nblk, plan_p.out_h, plan_p.out_w).sum())
    print(f"(l) packed front: {n_live} of {nb_cap} 16x512 blocks live "
          f"({100 * n_live / nb_cap:.1f} %, {n_listed} of {plan_p.out_h * plan_p.out_w} "
          f"windows); {n_prep_p} windows after prep, {n_front_p} after stages "
          f"1..{n_dense - 1}; equal to the twin and to the front kernel (tolerance: exact)",
          flush=True)
    check((n_prep_p, n_front_p) == (n_prep, n_front),
          "survivor counts differ between the shelf-packed and the plain-stack canvas")

    # (m) end to end, dense and packed front on the shelf-packed plan
    plain_rects = [sorted(map(tuple, positions_to_rects(plan, got[k]).tolist()))
                   for k in range(4)]
    shelf = {}
    for pf in (False, True):
        d = TorchDetector(model, exact=False, device=dev, packed_front=pf)
        d_ref = TorchDetector(model, exact=False, device=dev, impl="ref", packed_front=pf)
        kern, other = ("packed_front", "front") if pf else ("front", "packed_front")
        _build.LAUNCHES.clear()
        got_p = [d.raw_windows(frames[k], SF)[1] for k in range(4)]
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        for name in ("integral", kern, "patchify"):
            check(counts.get(name, 0) > 0, f"kernel {name} was not launched (packed_front={pf})")
        check(other not in counts, f"kernel {other} was launched (packed_front={pf})")
        if pf:
            launches["packed_front"] = counts["packed_front"]
        for k in range(4):
            check(np.array_equal(got_p[k], d_ref.raw_windows(frames[k], SF)[1]),
                  f"shelf-packed frame {k} (packed_front={pf}): kernel path != twin path")
            ours = sorted(map(tuple, positions_to_rects(plan_p, got_p[k]).tolist()))
            check(ours == plain_rects[k],
                  f"shelf-packed frame {k} (packed_front={pf}): raw windows map to other "
                  "rects than the plain stack's")
        for g in golden["frames"]:
            for mn in (3, 0):
                ours = sorted(map(list, TorchDetector.group(plan_p, got_p[g["k"]], mn).tolist()))
                check(ours == g[f"rects_mn{mn}"],
                      f"shelf-packed frame {g['k']} (packed_front={pf}) minNeighbors {mn}: "
                      f"{len(ours)} rects vs {len(g[f'rects_mn{mn}'])} in the OpenCV golden")
        print(f"(m) e2e shelf-packed, packed_front={pf}: frames 0-3 raw windows "
              f"{[len(x) for x in got_p]} equal to the twin path and map to the plain "
              f"stack's rects; frames 0,1 equal the OpenCV golden at minNeighbors 3 and 0; "
              f"launches {counts}", flush=True)
        shelf[pf] = d

    # (n) timing
    for pf, d in shelf.items():
        detection_timing(f"n, packed_front={pf}", d, frames, SF, smi)
    blk_ms = cuda_ms(lambda: live_block_list(alive_p), 20)
    dense_ms = cuda_ms(lambda: front(sp_k, inv_p, alive_p, cas, 1, n_dense), 20)
    packed_ms = cuda_ms(lambda: packed_front(sp_k, inv_p, alive_p, blk, nblk, cas, 1, n_dense),
                        20)
    print(f"(n) shelf-packed canvas, frame 0: front kernel {dense_ms:.4f} ms, packed_front "
          f"kernel {packed_ms:.4f} ms ({packed_ms / dense_ms:.2f} x the front), live-block "
          f"list {blk_ms:.4f} ms (list and packed_front {(blk_ms + packed_ms) / dense_ms:.2f} x "
          "the front)", flush=True)
    front_eval_p = [n_prep_p] + [
        int(front(sp_k, inv_p, alive_p, cas, 1, s).sum()) for s in range(2, n_dense)
    ]
    timed["packed_front"] = (
        lambda: packed_front(sp_k, inv_p, alive_p, blk, nblk, cas, 1, n_dense),
        lambda: packed_front(sp_k, inv_p, alive_p, blk, nblk, cas, 1, n_dense, impl="ref"),
        None, 3)
    # the listed blocks' windows: canvas cell, inv_nf, mask in and out;
    # plus the list
    work["packed_front"] = bound(10 * n_listed + 8 * n_live + 4,
                                 cascade_ops(cas, 1, front_eval_p))

    prep_phase(dev, model, timed, work, errs, launches)

    # ------------------------------------------------------------------
    # (o) the tiled kernels at their edges
    t0 = time.perf_counter()
    for label, cascade, ranges, use_stage in (
        ("front, frontal face", cas, FRONT_RANGES, False),
        ("stage, upper body", cas_b, STAGE_RANGES, True),
        ("stage, frontal face, sum2d as tilt2d", cas, ((0, len(cas.stages)),), True),
    ):
        n_cases, n_alive, bad = edge_mismatches(cascade, ranges, dev, use_stage)
        torch.cuda.synchronize()
        check(not bad, f"(o) {label}: kernel != twin at {bad}")
        print(f"(o) edges, {label}: {n_cases} cases (3 shapes x 4 masks x stage ranges "
              f"{list(ranges)}) equal to the twin (tolerance: exact); {n_alive} survivors "
              "in all", flush=True)
    n_cases, n_alive, bad = packed_edge_mismatches(cas, dev)
    torch.cuda.synchronize()
    check(not bad, f"(o) packed_front: kernel != twin or != front at {bad}")
    print(f"(o) edges, packed_front, frontal face: {n_cases} cases (4 shapes x 4 masks x 6 "
          f"block lists x 2 stage ranges) equal to the twin, and to the front kernel where "
          f"every block is listed (tolerance: exact); {n_alive} survivors in all", flush=True)
    n_cases, bad = tilted_edge_mismatches(dev)
    torch.cuda.synchronize()
    check(not bad, f"(o) tilted: kernel != twin at {bad}")
    print(f"(o) edges, tilted: {n_cases} cases (7 widths x 4 pads on a canvas of 9 runs of "
          "rows) equal to the twin (tolerance: exact)", flush=True)
    n_cases, bad = integral_edge_mismatches(dev)
    torch.cuda.synchronize()
    check(not bad, f"(o) integral: kernel != twin at {bad}")
    print(f"(o) edges, integral: {n_cases} cases ({len(INTEGRAL_HEIGHTS)} heights x "
          f"{len(INTEGRAL_WIDTHS)} widths x uint8 and int32) equal to the twin (tolerance: "
          "exact)", flush=True)
    n_cases, bad = cat_split_edge_mismatches(dev)
    torch.cuda.synchronize()
    check(not bad, f"(o) cat_split: kernel != plain version at {bad}")
    print(f"(o) edges, cat_split: {n_cases} cases ({len(CAT_NS)} sample counts around the "
          f"tree's levels x 4 features, 3 blocks around one wave of warps; x 3 policies) "
          "equal to the plain version (tolerance: exact)", flush=True)
    n_cases, bad = class_split_edge_mismatches(dev)
    torch.cuda.synchronize()
    check(not bad, f"(o) split_scan_class_gather: kernel != plain version at {bad}")
    print(f"(o) edges, split_scan_class_gather: {n_cases} cases (20 blocks x 2 layouts x 2 "
          "policies: 1-4097 samples, both sides of the shared table, all masked, one class, "
          "equal values, ±0.0, a masked chunk, ties) equal to the plain version on the CPU "
          "(tolerance: exact)", flush=True)
    for x in (px, px32):
        again = integral(x)
        check(torch.equal(again[0], s_k) and torch.equal(again[1], q_k),
              f"(o) integral kernel ({x.dtype}): two runs on the same inputs differ")
    again = front(s_k, inv_nf, alive0, cas, 1, n_dense)
    check(torch.equal(again, f_k), "(o) front kernel: two runs on the same inputs differ")
    again = packed_front(sp_k, inv_p, alive_p, blk, nblk, cas, 1, n_dense)
    check(torch.equal(again, pf_k), "(o) packed_front kernel: two runs on the same inputs differ")
    again = tilted(px_b, plan_b.is_top, pad)
    check(torch.equal(again, t_k), "(o) tilted kernel: two runs on the same inputs differ")
    again = stage(sb, t_k, inv_b, alive_b, cas_b, 0, n_st)
    check(torch.equal(again[0], a_k) and torch.equal(again[1], p0_k),
          "(o) stage kernel: two runs on the same inputs differ")
    via_stage = stage(s_k, s_k, inv_nf, alive0, cas, 1, n_dense)
    check(torch.equal(via_stage[0], f_k) and not via_stage[1].any(),
          "(o) the front's stages through the stage kernel != front kernel")
    own_ms = cuda_ms(lambda: front(s_k, inv_nf, alive0, cas, 1, n_dense), 20)
    via_ms = cuda_ms(lambda: stage(s_k, s_k, inv_nf, alive0, cas, 1, n_dense), 20)
    print(f"(o) two runs of each kernel on frame 0's 1080p inputs are equal; stages "
          f"1..{n_dense - 1} on the plain-stack canvas: front kernel {own_ms:.4f} ms, the "
          f"same stages through the stage kernel {via_ms:.4f} ms; phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the tile kernel's other policies at the same edges, f32 and f64
    t0 = time.perf_counter()
    knife = {}
    for label, m_e, exacts in policy_edge_cases():
        c_e = PackedCascade.from_model(m_e)
        for exact in exacts:
            for use_stage in (True, False):
                if c_e.has_tilted and not use_stage:
                    continue
                ranges = policy_ranges(len(c_e.stages), use_stage)
                n_cases, n_alive, bad = edge_mismatches(c_e, ranges, dev, use_stage, exact)
                torch.cuda.synchronize()
                kern = "stage" if use_stage else "front"
                check(not bad, f"(o) {kern}, {label}, exact={exact}: kernel != twin at {bad}")
                if label.startswith("knife") and use_stage:
                    knife[exact] = n_alive
                print(f"(o) edges, {kern} ({c_e.kind} policy, {'f64' if exact else 'f32'}), "
                      f"{label}: {n_cases} cases (3 shapes x 4 masks x stage ranges "
                      f"{list(ranges)}) equal to the twin (tolerance: exact); {n_alive} "
                      "survivors in all", flush=True)
    check(knife[False] != knife[True], "(o) the knife-edge cascade: f32 and f64 agree")
    n_cases, n_alive, bad = packed_edge_mismatches(cas, dev, exact=True)
    torch.cuda.synchronize()
    check(not bad, f"(o) packed_front f64: kernel != twin or != front at {bad}")
    print(f"(o) edges, packed_front (f64), frontal face: {n_cases} cases equal to the twin and "
          f"to the front kernel where every block is listed (tolerance: exact); {n_alive} "
          f"survivors; knife-edge survivors f32 {knife[False]} vs f64 {knife[True]}; the "
          f"policies took {time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------------------------------------------
    # (p) exact: f64 stage sums, the detector's default
    t0 = time.perf_counter()
    ctx = dict(dev=dev, frames=frames, sf=SF, smi=smi, timed=timed, work=work,
               launches=launches, errs=errs, max_abs_err=max_abs_err)
    det_x = TorchDetector(model, device=dev, pack_band=False)
    check(det_x.exact and det_x.engine_name == "fused", "exact=True is not the default")
    det_xp = TorchDetector(model, device=dev, packed_front=True)
    det_bx = TorchDetector(body, device=dev)
    check(det_bx.exact and det_bx.engine_name == "pallas", "upper body: not exact on pallas")
    inv_x, alive_x = det_x.engine.prep(s_k, q_k, plan)
    fx = kernel_vs_twin("front (f64)", lambda **kw: front(s_k, inv_x, alive_x, cas, 1, n_dense,
                                                          exact=True, **kw), ctx)
    inv_xp, alive_xp = det_xp.engine.prep(sp_k, qp_k, plan_p)
    blk_x, nblk_x = live_block_list(alive_xp)
    pfx = kernel_vs_twin("packed_front (f64)", lambda **kw: packed_front(
        sp_k, inv_xp, alive_xp, blk_x, nblk_x, cas, 1, n_dense, exact=True, **kw), ctx)
    check(torch.equal(pfx, front(sp_k, inv_xp, alive_xp, cas, 1, n_dense, exact=True)),
          "(p) packed_front f64 != front f64 on the same inputs")
    sx = kernel_vs_twin("stage (f64)", lambda **kw: stage(sb, t_k, inv_b, alive_b, cas_b, 0,
                                                          n_st, exact=True, **kw), ctx)
    print(f"(p) exact: kernels front ({int(fx.sum())} survivors of {int(alive_x.sum())}), "
          f"packed_front and stage ({int(sx[0].sum())} after all {n_st} stages) in f64 equal "
          "their twins at 1080p (tolerance: exact)", flush=True)
    paths_x = (("frontal face, plain stack", det_x, plan, 4, golden, "front"),
               ("frontal face, shelf-packed, packed front", det_xp, plan_p, 2, golden,
                "packed_front"),
               ("upper body", det_bx, plan_b, 2, golden_ub, "stage"))
    for label, d, pl, n_twin, gold, kern in paths_x:
        d_ref = TorchDetector(d.model, device=dev, impl="ref", pack_band=d.pack_band,
                              packed_front=kern == "packed_front")
        counts, got_x = e2e(d, frames, SF, range(max(n_twin, 2)), (kern,))
        for k in range(n_twin):
            check(np.array_equal(got_x[k], d_ref.raw_windows(frames[k], SF)[1]),
                  f"(p) {label} frame {k}: kernel path != twin path")
        check_golden(f"(p) {label}", pl, got_x, gold)
        launches[f"{kern} (f64)"] = (counts[kern], len(got_x))
        print(f"(p) e2e exact, {label}: frames 0-{n_twin - 1} raw windows "
              f"{[len(got_x[k]) for k in range(n_twin)]} equal to the twin path; frames 0,1 "
              f"equal the OpenCV golden at minNeighbors 3 and 0; launches {counts}", flush=True)
    for label, d, *_ in paths_x:
        detection_timing(f"p, {label}", d, frames, SF, smi)
    fx_eval = [int(alive_x.sum())] + [
        int(front(s_k, inv_x, alive_x, cas, 1, s, exact=True).sum()) for s in range(2, n_dense)]
    fxp_eval = [int(alive_xp.sum())] + [
        int(front(sp_k, inv_xp, alive_xp, cas, 1, s, exact=True).sum()) for s in range(2, n_dense)]
    sx_eval = [plan_b.out_h * plan_b.out_w] + [
        int(stage(sb, t_k, inv_b, alive_b, cas_b, 0, s, exact=True)[0].sum())
        for s in range(1, n_st)]
    n_listed_x = int(listed_windows(blk_x, nblk_x, plan_p.out_h, plan_p.out_w).sum())
    work["front (f64)"] = bound(4 * hw + 6 * n_win, cascade_ops(cas, 1, fx_eval))
    work["packed_front (f64)"] = bound(10 * n_listed_x + 8 * int(nblk_x[0]) + 4,
                                       cascade_ops(cas, 1, fxp_eval))
    work["stage (f64)"] = bound(2 * 4 * sb.numel() + 7 * plan_b.out_h * plan_b.out_w,
                                cascade_ops(cas_b, 0, sx_eval))
    f64_adds = sum(n * cas_b.stages[i].ntrees for i, n in enumerate(sx_eval))
    print(f"(p) stage (f64): {f64_adds} f64 adds take {f64_adds / F64_OPS_PER_S * 1e3:.4f} ms "
          f"at 34 TFLOP/s, under the f32-rate bound {work['stage (f64)'][0]:.4f} ms, which "
          f"stays; phase took {time.perf_counter() - t0:.1f} s", flush=True)
    profiled = [("frontal face exact, plain stack", det_x), ("upper body exact", det_bx)]

    # ------------------------------------------------------------------
    # (q) node trees and (r) LBP: every stage in the tile kernel
    for tag, xml_name, golden_name in (
        ("q", "haarcascade_frontalface_alt2.xml", "smoke_golden_alt2_1080p.json"),
        ("r", "lbpcascade_frontalface.xml", "smoke_golden_lbp_1080p.json"),
    ):
        profiled += cascade_phase(tag, os.path.join(data, xml_name),
                                  os.path.join(data, golden_name), img0, ctx)

    # ------------------------------------------------------------------
    # (s) training, (t) LBP and the other boost types
    values_extra = {}  # kernel name -> {key: value}: further numbers beside the kernel's
    vec, bg, s_stages = training_phase(dev, timed, work, errs, launches, timed_extra)
    mine_phase(dev, bg, s_stages, timed, work, errs, timed_extra, values_extra)
    boost_types_phase(dev, vec, bg, timed, work, errs, launches, timed_extra, values_extra)

    # ------------------------------------------------------------------
    # (u) deep weak trees, (v) HOG training and detection
    deep_phase(dev, vec, bg, launches, values_extra)
    hog_phase(dev, vec, bg, timed, work, errs, launches, timed_extra, values_extra)

    # ------------------------------------------------------------------
    # (w) multi-device training, (x) the command-line tools and traces
    multi_device_phase(dev, vec, bg, values_extra)
    tools_phase(dev, vec, bg, os.path.join(data, "haarcascade_frontalface_alt.xml"), frames[0],
                golden, values_extra)

    # ------------------------------------------------------------------
    # (y) the host library
    native_phase(host_build_s, {"plain stack": det, "shelf-packed": shelf[False]}, frames, SF,
                 smi)

    meta = {
        "prep": ("cascadeclassifier_tpu_torch/csrc/prep.cu",
                 "cascadeclassifier_tpu/detect/engine.py:656 (FusedEngine prep head, XLA, "
                 "not Pallas)"),
        "integral": ("cascadeclassifier_tpu_torch/csrc/integral.cu",
                     "cascadeclassifier_tpu/detect/pallas_integral.py:50"),
        "front": ("cascadeclassifier_tpu_torch/csrc/front.cu",
                  "cascadeclassifier_tpu/detect/pallas_front.py:610; "
                  "cascadeclassifier_tpu/detect/pallas_front.py:75"),
        "patchify": ("cascadeclassifier_tpu_torch/csrc/patchify.cu",
                     "cascadeclassifier_tpu/detect/compact.py:675"),
        "tilted": ("cascadeclassifier_tpu_torch/csrc/tilted.cu",
                   "cascadeclassifier_tpu/detect/dense.py:343 (XLA scan, not Pallas)"),
        "stage": ("cascadeclassifier_tpu_torch/csrc/stage.cu",
                  "cascadeclassifier_tpu/detect/pallas_stage.py:92"),
        "packed_front": ("cascadeclassifier_tpu_torch/csrc/packed_front.cu",
                         "cascadeclassifier_tpu/detect/pallas_front.py:326; "
                         "cascadeclassifier_tpu/detect/pallas_front.py:470"),
    }
    stump_f64 = "; cascadeclassifier_tpu/detect/dense.py:160 (XLA dense_stage_haar, exact)"
    meta.update({
        "front (f64)": (meta["front"][0], meta["front"][1] + stump_f64),
        "packed_front (f64)": (meta["packed_front"][0], meta["packed_front"][1] + stump_f64),
        "stage (f64)": (meta["stage"][0], meta["stage"][1] + stump_f64),
        "stage (node)": ("cascadeclassifier_tpu_torch/csrc/tile_node.cu",
                         "cascadeclassifier_tpu/detect/pallas_stage.py:92; "
                         "cascadeclassifier_tpu/detect/dense.py:292 (XLA dense_stage_deep)"),
        "front (node)": ("cascadeclassifier_tpu_torch/csrc/tile_node.cu",
                         "cascadeclassifier_tpu/detect/pallas_front.py:610; "
                         "cascadeclassifier_tpu/detect/dense.py:292 (XLA dense_stage_deep)"),
        "stage (lbp)": ("cascadeclassifier_tpu_torch/csrc/tile_lbp.cu",
                        "cascadeclassifier_tpu/detect/pallas_stage.py:92; "
                        "cascadeclassifier_tpu/detect/dense.py:202 (XLA dense_stage_lbp)"),
        "front (lbp)": ("cascadeclassifier_tpu_torch/csrc/tile_lbp.cu",
                        "cascadeclassifier_tpu/detect/pallas_front.py:610; "
                        "cascadeclassifier_tpu/detect/dense.py:202 (XLA dense_stage_lbp)"),
        "split_scan": ("cascadeclassifier_tpu_torch/csrc/split_scan.cu",
                       "cascadeclassifier_tpu/train/boost.py:74 (XLA _ordered_split_sorted, "
                       "not Pallas)"),
        "split_scan_gather": ("cascadeclassifier_tpu_torch/csrc/split_scan.cu",
                              "cascadeclassifier_tpu/train/boost.py:129 (XLA "
                              "_ordered_split_block after its sort, not Pallas)"),
        "cat_split": ("cascadeclassifier_tpu_torch/csrc/cat_split.cu",
                      "cascadeclassifier_tpu/train/boost.py:146 (XLA _categorical_split_block, "
                      "not Pallas); cascadeclassifier_tpu/train/boost.py:274 (XLA "
                      "_categorical_class_split_block)"),
        "split_scan_class_gather": ("cascadeclassifier_tpu_torch/csrc/split_class.cu",
                                    "cascadeclassifier_tpu/train/boost.py:214 (XLA "
                                    "_ordered_class_split_sorted, not Pallas); "
                                    "cascadeclassifier_tpu/train/boost.py:258"),
        "hog_hist": ("cascadeclassifier_tpu_torch/csrc/hog_hist.cu",
                     "cascadeclassifier_tpu/ops/features.py:537 (XLA hog_integral_histogram, "
                     "not Pallas)"),
        "hog_eval": ("cascadeclassifier_tpu_torch/csrc/hog_eval.cu",
                     "cascadeclassifier_tpu/train/evaluators.py:296-310 (XLA einsum and dot, "
                     "not Pallas); cascadeclassifier_tpu/ops/features.py:578 (XLA eval_hog)"),
        "mine": ("cascadeclassifier_tpu_torch/csrc/mine.cu",
                 "cascadeclassifier_tpu/train/predictor.py:518 (XLA _dense_chunk_fn, not "
                 "Pallas)"),
    })
    kernels = []
    for name, (fk, fr, flib, plain_reps) in timed.items():
        ms = cuda_ms(fk, 20)
        plain_ms = fr if isinstance(fr, float) else cuda_ms(fr, plain_reps)
        library_ms = cuda_ms(flib, 20) if flib is not None else None
        bound_ms, bound_by = work[name]
        extra = integral_extra if name == "integral" else {}
        extra = {**extra, **{k: cuda_ms(f, 20) for k, f in timed_extra.get(name, {}).items()}}
        n_launch = launches[name]
        if isinstance(n_launch, tuple):  # (launches, frames) of a newer path
            extra = {"launches_per_frame": n_launch[0] / n_launch[1]}
            n_launch = n_launch[0]
        extra.update(values_extra.get(name, {}))
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": n_launch,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra,
        })
        print(f"kernel {name}: {ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}"
              + "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}"
                        for k, v in extra.items()), flush=True)
    syncs = {}
    for name, d in (("frontal face", det), ("upper body", det_b),
                    ("frontal face shelf-packed", shelf[False]),
                    ("frontal face shelf-packed, packed front", shelf[True]), *profiled):
        syncs[name] = profile(name, d, frames[:4], SF)
    check(syncs["frontal face shelf-packed, packed front"] <= syncs["frontal face shelf-packed"],
          "the packed front adds host synchronizations")
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


TRAIN_DIR = os.path.join(HERE, "_train_smoke")  # gitignored, removed at the end


class ThreeStages(Exception):
    """Ends a phase's training run after its third stage."""


def checked_trainer(tag: str, mismatches: list, **kw):
    """A CascadeTrainer(**kw) that holds each stage's first mining
    superbatch against a CPU trainer's (the count of differing masks goes
    to mismatches, the seconds the CPU took to its ``check_s``, which the
    stage's ``fill_negatives`` includes), and stops its run once 3 stages
    are trained."""
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer

    cpu_kw = {**kw, "device": "cpu"}

    class Checked(CascadeTrainer):
        def _fill_positives(self, pos, count, consumed):
            if len(self.stages) == 3:
                raise ThreeStages
            return super()._fill_positives(pos, count, consumed)

        def _predictor(self):
            pred = super()._predictor()
            real, first = pred.predict_levels, [True]
            cpu = CascadeTrainer(**cpu_kw)

            def predict_levels(levels, ww, wh):
                got = real(levels, ww, wh)
                if self.stages and sum(len(lv[1]) for lv in levels):
                    self.superbatches += 1
                if first[0]:
                    first[0] = False
                    t0 = time.perf_counter()
                    want = type(pred)(lambda: cpu.evaluator, self.stages).predict_levels(
                        levels, ww, wh)
                    self.check_s.append(time.perf_counter() - t0)
                    mismatches.append(int(sum((g != c).sum() for g, c in zip(got, want))))
                    print(f"({tag}) stage {len(self.stages)}: first mining superbatch, "
                          f"{sum(len(g) for g in got)} windows, {int(sum(g.sum() for g in got))}"
                          f" accepted, {mismatches[-1]} masks differ from the CPU's", flush=True)
                return got

            pred.predict_levels = predict_levels
            return pred

    trainer = Checked(**kw)
    trainer.check_s = []
    trainer.superbatches = 0  # predict_levels calls that had windows and stages
    return trainer


def check_mine_launches(tag: str, trainer, dense: bool) -> int:
    """The dense miner's launches in a checked run: one a superbatch of a
    stump cascade (Haar, LBP), none for deep trees or HOG (the gather
    path, as the JAX package dispatches them) → the launches."""
    from cascadeclassifier_tpu_torch import _build

    n = _build.LAUNCHES.get("mine", 0)
    want = trainer.superbatches if dense else 0
    check(n == want, f"({tag}) kernel mine launched {n} times over {trainer.superbatches} "
                     f"mining superbatches, expected {want}")
    print(f"({tag}) the miner: {trainer.superbatches} superbatches, kernel mine launched {n} "
          f"times ({'one a superbatch' if dense else 'the gather path'})", flush=True)
    return n


def net_fill(tm, trainer, si: int) -> str:
    """fill_negatives of stage si less the CPU's check inside it."""
    return (f"fill_negatives net of the CPU's check "
            f"{tm['fill_negatives'][si] - trainer.check_s[si]:.2f} s")


def split_library(vs, ws, rs, kept, total_w, total_r):
    """The split search as library calls (torch.cumsum, torch.where,
    torch.max), for its time only: the cumsum's order is not the JAX
    package's."""
    inf = torch.tensor(float("inf"), device=vs.device)
    lw, lr = torch.cumsum(ws, 0), torch.cumsum(rs, 0)
    rw, rr = total_w - lw, total_r - lr
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(kept, vs, inf), [0]), 0).values, [0])
    nxt = torch.cat([nxt[1:], inf.expand(1, vs.shape[1])])
    ok = kept & (vs + 2.384185791015625e-07 < nxt) & (lw > 0) & (rw > 0)
    q, best = torch.max(torch.where(ok, (lr * lr * rw + rr * rr * lw) / (lw * rw),
                                    float("-inf")), 0)
    return q, (vs.gather(0, best[None]) + nxt.gather(0, best[None]))[0] * 0.5


def training_phase(dev, timed, work, errs, launches, timed_extra):
    """(s): the trainer on the card at 24x24 Haar BASIC, GAB stumps, the
    CLI's budgets; see the module docstring."""
    import shutil

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.data.vec import PosReader, write_vec
    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, positions_to_rects
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml, write_cascade_xml
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.train import boost
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator
    from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor
    from cascadeclassifier_tpu_torch.train.split import split_scan, split_scan_gather, tree_sum
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer
    from cascadeclassifier_tpu_torch.utils import train_data
    from cascadeclassifier_tpu_torch.utils.profiling import reset_timings, timings

    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    vec = os.path.join(TRAIN_DIR, "pos.vec")
    write_vec(vec, train_data.positives(1200, 24, seed=7))
    names = []
    for k in range(20):
        names.append(os.path.join(TRAIN_DIR, f"bg{k}.pgm"))
        train_data.write_pgm(names[-1], train_data.background(1080, 1920, seed=100 + k))
    bg = os.path.join(TRAIN_DIR, "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    print(f"(s) data: 1200 positives 24x24 in a .vec, 20 clutter backgrounds 1920x1080 as "
          f"PGM, {time.perf_counter() - t0:.1f} s", flush=True)

    # -- check 1: the kernel on stage 0's blocks at two boosting iterations
    t1 = time.perf_counter()
    tr = CascadeTrainer(device=dev)
    pos = tr._fill_positives(PosReader(vec, 24, 24), 1000, [0])
    neg = tr._fill_negatives(NegReader(bg, 24, 24, lazy=True), 2000, 0.0, [0])
    n, n_pad = 3000, 3072  # the trainer pads the sample axis to a multiple of 256
    samples = np.concatenate([pos, neg, np.zeros((n_pad - n, 24, 24), np.uint8)])
    labels = np.concatenate([np.ones(1000, np.int32), np.zeros(n_pad - 1000, np.int32)])
    valid = np.arange(n_pad) < n
    ev = tr.evaluator
    ev.set_samples(samples)
    calls = capture_splits(boost.StageTrainer(ev, boost.BoostParams(weak_count=2,
                                                                    max_false_alarm=0.0)),
                           labels, valid)
    check(len(calls) == 2, f"stage 0 took {len(calls)} split searches, expected 2")
    n_blocks, worst = 0, {"split_scan": 0.0, "split_scan_gather": 0.0}
    full_block = None
    for it, (cache, w, resp, mask) in enumerate(calls):
        cache.set_stage(valid, resp)  # the sorted views fast_inputs reads
        # a tree root's mask is valid & (w >= the trim threshold): the least
        # masked weight is a threshold that gives the same mask
        wthr = float(w[mask].min())
        check(np.array_equal(valid & (w >= wthr), mask), "the mask is not a root's")
        w_dev = torch.as_tensor(w, device=dev)
        r_dev = torch.as_tensor(resp, device=dev)
        m_dev = torch.as_tensor(mask, device=dev)
        wm_dev = torch.where(m_dev, w_dev, 0.0)
        rm_dev = wm_dev * r_dev
        wm = np.where(mask, w, 0.0)
        tw, trr = tree_sum(wm), tree_sum(wm * resp)
        for b in range(cache.num_blocks):
            fast = boost.fast_inputs(cache, b, w_dev, wthr)
            gen = boost.generic_inputs(cache, b, w_dev, r_dev, m_dev)
            check(all(torch.equal(x, y) for x, y in zip(fast, gen)),
                  f"split inputs of block {b}, iteration {it}: fast and generic paths differ")
            vs_bn, si_bn = torch.sort(cache.block_values(b), dim=1, stable=True)
            tables = (wm_dev, rm_dev, m_dev, tw, trr)
            gathered = {"resident": (cache.vs[b][0], cache.order[b][0]),  # contiguous (N, B)
                        "fresh": (vs_bn.t(), si_bn.t())}  # views of the sort's (B, N)
            check(all(torch.equal(x, y) for x, y in zip(gathered["resident"],
                                                         gathered["fresh"])),
                  f"block {b}: the resident sort differs from a fresh one")
            q_c, thr_c = split_scan_gather(*(x.cpu() for x in gathered["fresh"]),
                                           *(x.cpu() for x in tables[:3]), tw, trr)
            runs = {"split_scan": [split_scan(*fast, tw, trr), split_scan(*gen, tw, trr)],
                    "split_scan_gather": [split_scan_gather(*g, *tables)
                                          for g in gathered.values()]}
            for name, outs in runs.items():
                for q, thr in outs:
                    ok = torch.equal(q.cpu(), q_c) and torch.equal(thr.cpu(), thr_c)
                    check(ok, f"{name} != the plain version on the CPU: block {b}, "
                              f"iteration {it}")
                    fin = torch.isfinite(q_c)
                    worst[name] = max(worst[name],
                                      float((q.cpu()[fin] - q_c[fin]).abs().max()),
                                      float((thr.cpu() - thr_c).abs().max()))
            n_blocks += 1
            if full_block is None and fast[0].shape[1] == ev.block_size:
                full_block = (fast, gathered["fresh"], gathered["resident"], tables,
                              (w_dev, r_dev, m_dev))
    errs.update(worst)
    nb, nn = full_block[0][0].shape[1], full_block[0][0].shape[0]
    print(f"(s) check 1: on {n_blocks} blocks ({cache.num_blocks} blocks x 2 boosting "
          f"iterations of stage 0, {nn} samples x up to {nb} features) split_scan_gather "
          f"(resident (N, B) and fresh (B, N) sort outputs) and split_scan (the fast and "
          f"the generic callers' inputs, equal) bit for bit equal to the plain version on "
          f"the CPU; {time.perf_counter() - t1:.1f} s", flush=True)
    (vs, ws, rs, kept), (vs_f, order_f), (vs_r, order_r), tables, (w_dev, r_dev, m_dev) = \
        full_block
    wm_dev, rm_dev, m_dev, tw, trr = tables
    timed["split_scan"] = (lambda: split_scan(vs, ws, rs, kept, tw, trr),
                           lambda: split_scan(vs, ws, rs, kept, tw, trr, impl="ref"),
                           lambda: split_library(vs, ws, rs, kept, tw, trr), 2)
    timed["split_scan_gather"] = (
        lambda: split_scan_gather(vs_f, order_f, *tables),
        lambda: split_scan_gather(vs_f, order_f, *tables, impl="ref"),
        lambda: split_library(vs_f, wm_dev[order_f], rm_dev[order_f], m_dev[order_f], tw, trr),
        2)
    sorted_bn = (vs_f.t(), order_f.t())  # torch.sort's own (B, N) outputs

    def pr9_path():  # the transposes, generic_inputs' gathers and the array form
        vs_t, si_t = (x.t().contiguous() for x in sorted_bn)
        wm = torch.where(m_dev, w_dev, 0.0)
        return split_scan(vs_t, wm[si_t], (wm * r_dev)[si_t], m_dev[si_t], tw, trr)

    def new_path():  # the tables and the gathered form on the sort's outputs
        wm = torch.where(m_dev, w_dev, 0.0)
        return split_scan_gather(sorted_bn[0].t(), sorted_bn[1].t(), wm, wm * r_dev, m_dev,
                                 tw, trr)

    timed_extra["split_scan_gather"] = {
        "resident_ms": lambda: split_scan_gather(vs_r, order_r, *tables),
        "pr9_path_ms": pr9_path, "new_path_ms": new_path}
    # each input read once, each output written once; the f64 operations
    # (two scans, the quality, the compares) are far below the bytes' time
    work["split_scan"] = bound(nn * nb * (4 + 8 + 8 + 1) + nb * (8 + 4), 0)
    work["split_scan_gather"] = bound(nn * nb * (4 + 8) + nn * (8 + 8 + 1) + nb * (8 + 4), 0)
    del calls, cache
    torch.cuda.empty_cache()

    # -- check 2: three stages at full width, the CLI's budgets
    t2 = time.perf_counter()
    n_val = min(5, int(1024.0 * 2**20 // (4 * n_pad * ev.block_size)))  # FeatureCache's
    n_idx = min(n_val, int(1024.0 * 2**20 // (17 * n_pad * ev.block_size)))
    print(f"(s) check 2: the first 3 stages of a 20-stage run (the CLI's default, whose "
          f"leaf false-alarm target 0.5^20 keeps mining going), 1000 positives + 2000 "
          f"negatives (3072 with padding), "
          f"24x24 BASIC (162336 features, 5 blocks of 32768), GAB stumps, weak_count 100, "
          f"minHitRate 0.995, maxFalseAlarm 0.5, budgets 1024/1024 MB: {n_val} value "
          f"blocks and {n_idx} index blocks resident, so every tree re-evaluates "
          f"{5 - n_val} blocks and every block takes the generic split path", flush=True)
    mismatches = []
    full = os.path.join(TRAIN_DIR, "full")
    trainer = checked_trainer("s", mismatches, device=dev)
    reset_timings()
    _build.LAUNCHES.clear()
    try:  # the CLI's 20-stage run (its leaf false-alarm target), cut after stage 2
        trainer.train(full, vec, bg, num_pos=1000, num_neg=2000, num_stages=20)
    except ThreeStages:
        pass
    write_cascade_xml(trainer._to_model(), os.path.join(full, "cascade.xml"))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    launches["split_scan"] = counts.get("split_scan", 0)
    launches["split_scan_gather"] = counts.get("split_scan_gather", 0)
    launches["mine"] = check_mine_launches("s", trainer, True)
    check(launches["split_scan_gather"] > 0,
          "kernel split_scan_gather was not launched on the main path")
    check(launches["split_scan"] == 0,
          f"the trainer launched the array form split_scan {launches['split_scan']} times: it "
          f"builds (N, B) inputs in torch")
    check(len(trainer.stages) == 3, f"the trainer trained {len(trainer.stages)} stages, not 3")
    check(all(m == 0 for m in mismatches), f"accept masks differ from the CPU's: {mismatches}")
    files = sorted(os.listdir(full))
    check(files == ["cascade.xml", "params.xml", "stage0.xml", "stage1.xml", "stage2.xml"],
          f"checkpoint files {files}")
    resumed = CascadeTrainer(device=dev)
    check(resumed.load(full) and len(resumed.stages) == 3 and all(
        a.threshold == b.threshold and len(a.trees) == len(b.trees)
        for a, b in zip(resumed.stages, trainer.stages)), "the checkpoint does not resume")
    tm = timings()
    for si in range(3):
        per_stage = {k: tm[k][si] for k in ("fill_positives", "fill_negatives", "set_samples",
                                            "train_stage")}
        print(f"(s) stage {si}: {len(trainer.stages[si].trees)} trees, "
              f"{sum(per_stage.values()):.2f} s (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in per_stage.items()) +
              f"; {net_fill(tm, trainer, si)})", flush=True)
    print("(s) phase totals (device synchronized at each scope's ends): " + ", ".join(
        f"{k} {sum(v):.2f} s over {len(v)}" for k, v in sorted(tm.items())), flush=True)
    n_trees = sum(len(s.trees) for s in trainer.stages)
    print(f"(s) check 2: params.xml, stage0-2.xml and cascade.xml written, a new trainer "
          f"resumes the 3 stages from them", flush=True)
    print(f"(s) check 2: {n_trees} trees, split_scan_gather launched "
          f"{launches['split_scan_gather']} times ({launches['split_scan_gather'] / n_trees:.1f}"
          f" a tree), split_scan {launches['split_scan']}; train_stage "
          f"{sum(tm['train_stage']) / n_trees:.4f} s a tree; {time.perf_counter() - t2:.1f} s",
          flush=True)

    # -- check 3: stage 0 on the card and on the CPU, byte for byte
    t3 = time.perf_counter()
    outs = {}
    for where in (dev, "cpu"):
        d = os.path.join(TRAIN_DIR, f"stage0_{torch.device(where).type}")
        CascadeTrainer(device=where).train(d, vec, bg, num_pos=200, num_neg=400, num_stages=1,
                                           verbose=False)
        with open(os.path.join(d, "stage0.xml"), "rb") as f:
            outs[where] = f.read()
    check(outs[dev] == outs["cpu"], "stage0.xml trained on the card differs from the CPU's")
    print(f"(s) check 3: stage 0 at 200 positives + 400 negatives, trained on the card and "
          f"on the CPU: stage0.xml byte-identical ({len(outs['cpu'])} bytes); "
          f"{time.perf_counter() - t3:.1f} s", flush=True)

    # -- 75x32 (the barcode window): partial sums may pass 2^24, where the
    # card's order of f32 adds could differ from the CPU's; measured, not held
    cat = haar_catalog(75, 32, "BASIC")
    rng = np.random.default_rng(0)
    x75 = rng.integers(200, 256, (64, 32, 75)).astype(np.uint8)
    area = cat.rects[:, 0, 2] * cat.rects[:, 0, 3]
    ids = np.unique(np.concatenate([np.argsort(-area, kind="stable")[:2000],
                                    rng.choice(len(cat), 20000, replace=False)]))
    vals = []
    for where in (dev, "cpu"):
        ev75 = HaarTrainEvaluator(cat, device=where)
        ev75.set_samples(x75)
        vals.append(ev75.values_for_vars(ids).cpu())
    n_diff = int((vals[0] != vals[1]).sum())
    print(f"(s) 75x32 BASIC, 64 bright windows x {len(ids)} features (the 2000 largest): "
          f"{n_diff} of {vals[0].numel()} f32 values differ between the card and the CPU",
          flush=True)

    # -- check 4: the written cascade reads back and detects
    t4 = time.perf_counter()
    read = read_cascade_xml(os.path.join(full, "cascade.xml"))
    built = trainer._to_model()
    check(read.num_stages == built.num_stages and read.features == built.features and all(
        a.threshold == b.threshold and len(a.trees) == len(b.trees) and all(
            np.array_equal(ta.feature_idx, tb.feature_idx)
            and np.array_equal(ta.threshold, tb.threshold)
            and np.array_equal(ta.leaf_values, tb.leaf_values)
            for ta, tb in zip(a.trees, b.trees))
        for a, b in zip(read.stages, built.stages)), "cascade.xml does not read back")
    frame, placed = train_data.background(1080, 1920, seed=4242, marks=8)
    found = {}
    for engine in ("fused", "pallas"):
        det = TorchDetector(read, device=dev, engine=engine)
        plan, got = det.raw_windows(frame, 1.1)
        want = TorchDetector(read, device=dev, engine=engine, impl="ref").raw_windows(
            frame, 1.1)[1]
        torch.cuda.synchronize()
        check(torch.equal(torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()),
              f"trained cascade, engine {engine}: raw windows differ from the twin path")
        found[engine] = sorted(map(tuple, positions_to_rects(plan, got).tolist()))
    check(found["fused"] == found["pallas"] and len(found["fused"]) > 0,
          f"trained cascade: {len(found['fused'])} and {len(found['pallas'])} raw windows")
    hits = sum(any(abs(x - px) <= s // 4 and abs(y - py) <= s // 4 and abs(w - s) <= s // 3
                   for x, y, w, _h in found["fused"]) for px, py, s in placed)
    print(f"(s) check 4: cascade.xml reads back to the trained model; on a 1080p frame with "
          f"{len(placed)} planted marks both engines give the same {len(found['fused'])} raw "
          f"windows, equal to the twin path, {hits} of the marks among them; "
          f"{time.perf_counter() - t4:.1f} s", flush=True)

    # -- check 5: tilted features in the dense miner (the upright and the
    # tilted products, then the division), card against CPU
    t5 = time.perf_counter()
    stages = tilted_stumps(samples[:n], dev)
    levels, total = [], 0
    reader = NegReader(bg, 24, 24, lazy=True)
    while total < 40000:
        img, pos = reader.level_positions()
        levels.append((img, pos, (reader.last, float(reader.scale))))
        total += len(pos)
        reader.skip(len(pos))
    masks = {}
    for where in (dev, "cpu"):
        ev_all = HaarTrainEvaluator(haar_catalog(24, 24, "ALL"), device=where)
        masks[where] = CascadePredictor(lambda e=ev_all: e, stages).predict_levels(levels, 24, 24)
    n_tilted = len({int(t.feature_idx[0]) for st in stages for t in st.trees
                    if ev_all.catalog.tilted[t.feature_idx[0]]})
    n_ok = int(sum(m.sum() for m in masks[dev]))
    check(all(np.array_equal(a, b) for a, b in zip(masks[dev], masks["cpu"])),
          "tilted cascade: the card's mining masks differ from the CPU's")
    check(0 < n_ok < total, f"tilted cascade accepts {n_ok} of {total} windows")
    print(f"(s) check 5: a cascade of {sum(len(st.trees) for st in stages)} stumps over "
          f"Haar ALL features, {n_tilted} of them tilted: predict_levels on {len(levels)} mining "
          f"levels, {total} windows, {n_ok} accepted, masks equal to the CPU's; "
          f"{time.perf_counter() - t5:.1f} s", flush=True)
    print(f"(s) phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return vec, bg, trainer.stages


def covered_pixels(packed, ww: int, wh: int) -> tuple:
    """(lazy, eager) pixels of the levels that the table's windows cover,
    each pixel of a level counted once however many windows hold it."""
    from cascadeclassifier_tpu_torch.train import mine

    sy, sx = wh // 2, ww // 2
    masks = {}
    for r in packed.table.tolist():
        key = (r[mine.SRC_OFF], r[mine.EAGER], r[mine.SH], r[mine.SW], r[mine.DH], r[mine.DW])
        m = masks.setdefault(key, np.zeros((r[mine.DH], r[mine.DW]), bool))
        nx, first, last = r[mine.NX], r[mine.W0], r[mine.W0] + r[mine.COUNT] - 1
        for gy in range(first // nx, last // nx + 1):  # grid row gy: columns c0..c1
            c0 = first % nx if gy == first // nx else 0
            c1 = last % nx if gy == last // nx else nx - 1
            y, x = r[mine.OY] + gy * sy, r[mine.OX]
            m[y:y + wh, x + c0 * sx:x + c1 * sx + ww] = True
    per = [(k[1], int(m.sum())) for k, m in masks.items()]
    return sum(c for e, c in per if not e), sum(c for e, c in per if e)


def mine_ops(stages, reach, rects: dict, pixels: tuple, n: int) -> dict:
    """Integer, f32 and f64 operations the masks of n windows need, reach[s]
    windows evaluated by stage s, pixels (lazy, eager) level pixels
    covered (covered_pixels): a lazy pixel's build 9 (the two passes' 2
    products and 1 sum each, the rounding add, shift and clamp) and its
    integrals 5 (the sum's two adds, the square and its two adds), an
    eager pixel's integrals 5, counted once a level pixel; a window's norm
    factor 6 integer (two 4-corner sums), 4 f64 (two products, the
    difference, the sqrt) and its f32 cast; a Haar stump of k =
    rects[feature] weighted rects 5k - 1 integer (3k corner adds, k
    weights, k - 1 adds), 3 f32 (the conversion, the division, the
    compare) and its f64 prefix add; a stage's difference and compare 2
    f64. An IMAD or FMA counts as 2."""
    ops = {"int": 14 * pixels[0] + 5 * pixels[1] + 6 * n, "f32": n, "f64": 4 * n}
    for st, r in zip(stages, reach):
        k = [rects[int(t.feature_idx[0])] for t in st.trees]
        ops["int"] += r * sum(5 * x - 1 for x in k)
        ops["f32"] += r * 3 * len(k)
        ops["f64"] += r * (len(k) + 2)
    return ops


def mixed_bound(nbytes: float, ops: dict):
    """(least ms, what bounds it) of work in several types: the bytes over
    the memory rate, or the slowest type's operations over its rate (the
    integer, f32 and f64 pipes run side by side)."""
    rate = {"int": INT32_OPS_PER_S, "f32": F32_OPS_PER_S, "f64": F64_OPS_PER_S}
    op = max(v / rate[k] for k, v in ops.items()) * 1e3
    by = nbytes / HBM_BYTES_PER_S * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def mine_phase(dev, bg, stages, timed, work, errs, timed_extra, values_extra):
    """(z), run right after (s) on its data: the dense miner's tile kernel
    and the design it replaced at their edges and on 10 superbatches of
    (s)'s backgrounds under (s)'s 3 trained stages; see the module
    docstring."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.train import mine
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator
    from cascadeclassifier_tpu_torch.utils import time_mine
    from cascadeclassifier_tpu_torch.utils.edges import mine_edge_mismatches

    # -- check 1: the kernels at their edges
    t0 = time.perf_counter()
    before = _build.LAUNCHES.get("mine", 0)
    n_cases, n_win, bad = mine_edge_mismatches(dev)
    torch.cuda.synchronize()
    check(not bad, f"(z) kernel mine != mine_ref on the card: {bad}")
    check(_build.LAUNCHES["mine"] - before == n_cases, "(z) the edge cases took other than one "
                                                       "launch each")
    _n, _w, bad_warp = mine_edge_mismatches(dev, mine.mine_warp)
    torch.cuda.synchronize()
    check(not bad_warp, f"(z) the replaced design != mine_ref on the card: {bad_warp}")
    print(f"(z) check 1: kernel mine equal to mine_ref on the card on {n_cases} edge cases "
          f"(utils/edges.py: mine_edge_cases; {n_win} windows: nf = 0 windows, thresholds "
          f"equal to values, the last row and column, a scale-1 lazy level, a source 2 pixels "
          f"wide, eager levels, one window, an empty level, stage sets of 1 to 301 trees "
          f"across the blocks of 16 and 256, -0.0 leaves, LBP all-bits subsets and codes, "
          f"tilted features at the window's edge; runs starting and ending inside tiles, a "
          f"level inside one tile, a one-window last tile, nx = 1, a 13x11 window, tilted "
          f"features on tile borders), one launch a case (tolerance: exact); the replaced "
          f"design (a warp a window) equal too; {time.perf_counter() - t0:.1f} s", flush=True)

    # -- check 2: 10 superbatches of 131 072 windows under (s)'s stages
    t1 = time.perf_counter()
    batches = time_mine.superbatches(NegReader(bg, 24, 24, lazy=True), 10)
    check(len(batches) == 10, f"(z) {len(batches)} superbatches of (s)'s backgrounds")
    ev = HaarTrainEvaluator(haar_catalog(24, 24, "BASIC"), device=dev)
    rows = time_mine.time_superbatches(ev, stages, batches, 24, 24, dev)
    check(all(r["kernel_launches"] == 1 and r["warp_launches"] == 1 for r in rows),
          "(z) a superbatch took other than one launch of a kernel")
    reach = time_mine.evaluated_trees(ev, stages, batches[0], 24, 24, dev)
    for line in time_mine.report(rows).splitlines():
        print(f"(z) check 2: {line}", flush=True)
    print(f"(z) check 2: stages of {[len(st.trees) for st in stages]} stumps; windows reaching "
          f"each stage of superbatch 0 {reach}; levels a superbatch "
          f"{[r['levels'] for r in rows]}; each superbatch's masks of both kernels equal to "
          f"mine_ref's (tolerance: exact); {time.perf_counter() - t1:.1f} s", flush=True)
    used = sorted({int(t.feature_idx[0]) for st in stages for t in st.trees})
    feats = mine.features_of(ev, used)
    trees = mine.tree_table(stages, used, False, dev)
    packed = mine.pack_levels(batches[0], 24, 24, dev)
    wins = mine.level_windows(packed, 24, 24)
    comp = time_mine.composite_tables(feats, trees, 24, 24)
    timed["mine"] = (lambda: mine.mine(packed, feats, trees, 24, 24),
                     lambda: mine.mine(packed, feats, trees, 24, 24, impl="ref"),
                     lambda: time_mine.library_composite(wins, *comp), 2)
    timed_extra["mine"] = {"replaced_design_ms": lambda: mine.mine_warp(packed, feats, trees,
                                                                        24, 24)}
    errs["mine"] = 0  # every mask equal (checked above)
    srcs = {(r[mine.EAGER], r[mine.SRC_OFF]): r[mine.SH] * r[mine.SW]
            for r in packed.table.tolist()}
    nbytes = sum(srcs.values()) + 8 * packed.table.numel() + packed.n
    rects = dict(zip(used, (feats.weights != 0).sum(dim=1).tolist()))
    pixels = covered_pixels(packed, 24, 24)
    ops = mine_ops(stages, reach, rects, pixels, packed.n)
    work["mine"] = mixed_bound(nbytes, ops)
    print(f"(z) check 2: superbatch 0's bound: {pixels[0]} lazy and {pixels[1]} eager level "
          f"pixels covered, {packed.n} windows; {ops['int']} integer operations at "
          f"{INT32_OPS_PER_S:.4g}/s, {ops['f32']} f32 at {F32_OPS_PER_S:.4g}/s, {ops['f64']} "
          f"f64 at {F64_OPS_PER_S:.4g}/s; {nbytes} bytes at {HBM_BYTES_PER_S:.4g}/s -> "
          f"{work['mine'][0]:.5f} ms ({work['mine'][1]})", flush=True)
    kinds = {"ILi0E": "haar", "ILi1E": "haar_tilted", "ILi2E": "lbp"}
    regs = {}
    for name, r, st, ld in _build.kernel_resources("mine.cu"):
        kernel = "tile" if "tile_kernel" in name else "warp"
        regs[f"{kernel}_{next((v for k, v in kinds.items() if k in name), name)}"] = (r, st, ld)
    tiles = {name: mine.tile_info(24, 24, kind) for kind, name in zip(mine.KINDS, kinds.values())}
    mean = {k: float(np.mean([r[k] for r in rows])) for k in (
        "levels", "windows", "kernel_ms", "kernel_warm_ms", "warp_ms", "launch_ms",
        "warp_launch_ms", "pack_ms", "fetch_ms", "plain_ms", "composite_ms")}
    values_extra["mine"] = {
        "levels_per_superbatch": mean["levels"], "windows_per_superbatch": mean["windows"],
        "launches_per_superbatch": rows[0]["kernel_launches"],
        "superbatch_ms": mean["kernel_ms"], "superbatch_ms_sources_on_card":
            mean["kernel_warm_ms"], "launch_ms_events": mean["launch_ms"],
        "pack_levels_ms": mean["pack_ms"], "fetch_ms": mean["fetch_ms"],
        "replaced_design_superbatch_ms_sources_on_card": mean["warp_ms"],
        "replaced_design_launch_ms_events": mean["warp_launch_ms"],
        "level_pixels_covered": list(pixels),
        "plain_superbatch_ms": mean["plain_ms"], "composite_superbatch_ms": mean["composite_ms"],
        "plain_launches_per_superbatch": rows[0]["plain_launches"],
        "composite_launches_per_superbatch": rows[0]["composite_launches"],
        "windows_per_s": mean["windows"] / mean["kernel_warm_ms"] * 1e3,
        "stage_reach": reach,
        "ptxas": {name: list(v) for name, v in regs.items()},
        "tiles": {name: {"tile": list(t["tile"]), "shared_bytes": t["shared_bytes"],
                         "ctas_per_sm": t["ctas_per_sm"]} for name, t in tiles.items()},
    }
    for name, (r, st, ld) in regs.items():
        print(f"(z) ptxas {name}: {r} registers, spill stores {st} B, loads {ld} B", flush=True)
    for name, t in tiles.items():
        check(t["shared_bytes"] == t["layout_bytes"], f"(z) {name}: the source's tile layout "
                                                      f"and train/mine.py's differ")
        print(f"(z) tile kernel {name} at 24x24: a tile of {t['tile'][0]}x{t['tile'][1]} "
              f"windows, {t['shared_bytes']} shared bytes a CTA, {t['ctas_per_sm']} CTAs an SM",
              flush=True)
    print(f"(z) phase took {time.perf_counter() - t0:.1f} s", flush=True)


def tilted_stumps(samples, dev):
    """Two stages of stumps over 24x24 Haar ALL features, five tilted and
    one upright a stage (global indices), thresholds at quantiles of their
    values on the samples, each stage passing about half of them."""
    from cascadeclassifier_tpu_torch.models.model import Stage, WeakTree
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator

    ev = HaarTrainEvaluator(haar_catalog(24, 24, "ALL"), device=dev)
    ev.set_samples(samples)
    rng = np.random.default_rng(3)
    tilted = np.flatnonzero(ev.catalog.tilted)
    stages = []
    for s in range(2):
        ids = np.concatenate([rng.choice(tilted, 5, replace=False),
                              rng.choice(np.flatnonzero(~ev.catalog.tilted), 1)])
        vals = ev.values_for_vars(ids).cpu().numpy()
        trees, sums = [], 0.0
        for k, f in enumerate(ids):
            thr = np.float32(np.quantile(vals[k], 0.3 + 0.1 * k))
            leaves = np.array([-0.5 - 0.1 * k, 0.7], np.float32)
            trees.append(WeakTree(left=np.array([0], np.int32), right=np.array([-1], np.int32),
                                  feature_idx=np.array([f], np.int32),
                                  threshold=np.array([thr], np.float32), leaf_values=leaves))
            sums = sums + np.where(vals[k] <= thr, leaves[0], leaves[1]).astype(np.float64)
        stages.append(Stage(threshold=float(np.quantile(sums, 0.4 + 0.2 * s)), trees=trees))
    return stages


def cat_library(codes, t0, t1, policy: str):
    """The categorical split as library calls (two f64 scatter_add_
    histograms, a stable torch.sort, torch.cumsum, the quality and
    torch.max), for its time only: the adds' order is not the JAX
    package's."""
    b, n = codes.shape
    idx = (codes.long() + torch.arange(b, device=codes.device)[:, None] * 256).reshape(-1)
    h0 = torch.zeros(b * 256, dtype=torch.float64, device=codes.device)
    h1 = torch.zeros_like(h0)
    h0.scatter_add_(0, idx, t0.expand(b, n).reshape(-1))
    h1.scatter_add_(0, idx, t1.expand(b, n).reshape(-1))
    h0, h1 = h0.view(b, 256), h1.view(b, 256)
    key = torch.where(h0.abs() > 2.220446049250313e-16, h1 / h0, 0.0) if policy == "reg" else h1
    order = torch.sort(key, dim=1, stable=True).indices
    s0, s1 = h0.gather(1, order), h1.gather(1, order)
    if policy == "reg":
        s1 = key.gather(1, order) * s0
    l0, l1 = torch.cumsum(s0, 1), torch.cumsum(s1, 1)
    r0, r1 = h0.sum(1, keepdim=True) - l0, h1.sum(1, keepdim=True) - l1
    if policy == "reg":
        q = (l1 * l1 * r0 + r1 * r1 * l0) / (l0 * r0)
    else:
        q = torch.maximum(l0 + r1, l1 + r0)
    return torch.max(q[:, :255], 1)


def class_split_library(vs, w0s, w1s, kept, t0, t1):
    """The two-class (misclassification) split as library calls, for its
    time only."""
    inf = torch.tensor(float("inf"), device=vs.device)
    c0, c1 = torch.cumsum(w0s, 0), torch.cumsum(w1s, 0)
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(kept, vs, inf), [0]), 0).values, [0])
    nxt = torch.cat([nxt[1:], inf.expand(1, vs.shape[1])])
    ok = kept & (vs + 2.384185791015625e-07 < nxt)
    q, best = torch.max(torch.where(ok, torch.maximum(c0 + (t1 - c1), c1 + (t0 - c0)),
                                    float("-inf")), 0)
    return q, (vs.gather(0, best[None]) + nxt.gather(0, best[None]))[0] * 0.5


def capture_splits(st, labels, valid):
    """Train st (a StageTrainer) and keep the inputs of each split search."""
    calls = []
    find = st._find_best_split

    def capture(cache, w, resp, mask):
        calls.append((cache, w.copy(), resp.copy(), mask.copy()))
        return find(cache, w, resp, mask)

    st._find_best_split = capture
    st.train(labels, valid=valid, verbose=False)
    return calls


def boost_types_phase(dev, vec, bg, timed, work, errs, launches, timed_extra, values_extra):
    """(t): LBP training at 24x24 (all 8 464 features, GAB stumps, the
    categorical kernel) and a DAB stage (the two-class policy of the split
    kernel), on (s)'s data; see the module docstring."""
    import shutil

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.data.vec import PosReader
    from cascadeclassifier_tpu_torch.models.model import BOOST_DAB, FEATURE_LBP
    from cascadeclassifier_tpu_torch.train import boost
    from cascadeclassifier_tpu_torch.train.cat_split import (
        categorical_class_split,
        categorical_split,
    )
    from cascadeclassifier_tpu_torch.train.split import split_scan_class_gather, tree_sum
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer
    from cascadeclassifier_tpu_torch.utils.profiling import reset_timings, timings
    from cascadeclassifier_tpu_torch.utils.tune_cat_split import window_stats
    from cascadeclassifier_tpu_torch.utils.tune_split_class import (
        ctas_per_sm,
        run_scan_policy,
        scan_policy_kernels,
    )

    t0 = time.perf_counter()
    lbp = CascadeTrainer(feature_type=FEATURE_LBP, device=dev)
    pos = lbp._fill_positives(PosReader(vec, 24, 24), 1000, [0])
    neg = lbp._fill_negatives(NegReader(bg, 24, 24, lazy=True), 2000, 0.0, [0])
    n, n_pad = 3000, 3072
    samples = np.concatenate([pos, neg, np.zeros((n_pad - n, 24, 24), np.uint8)])
    labels = np.concatenate([np.ones(1000, np.int32), np.zeros(n_pad - 1000, np.int32)])
    valid = np.arange(n_pad) < n
    cls = labels == 1

    # -- check 1: the categorical kernel on stage 0's code block at two
    # boosting iterations, every policy, against its plain version
    ev = lbp.evaluator
    ev.set_samples(samples)
    calls = capture_splits(boost.StageTrainer(ev, boost.BoostParams(weak_count=2,
                                                                    max_false_alarm=0.0)),
                           labels, valid)
    check(len(calls) == 2 and calls[0][0].num_blocks == 1,
          f"LBP stage 0: {len(calls)} split searches over {calls[0][0].num_blocks} blocks")
    codes = calls[0][0].block_values(0)
    worst = 0.0
    for it, (_cache, w, resp, mask) in enumerate(calls):
        wm = torch.as_tensor(np.where(mask, w, 0.0), device=dev)
        tables = {"reg": (wm, wm * torch.as_tensor(resp, device=dev)),
                  "class": (torch.where(torch.as_tensor(cls, device=dev), 0.0, wm),
                            torch.where(torch.as_tensor(cls, device=dev), wm, 0.0))}
        runs = {"reg": lambda impl="auto": categorical_split(codes, *tables["reg"], impl=impl),
                "misclass": lambda impl="auto": categorical_class_split(
                    codes, *tables["class"], False, impl=impl),
                "gini": lambda impl="auto": categorical_class_split(
                    codes, *tables["class"], True, impl=impl)}
        for policy, run in runs.items():
            (q, sub), (q_t, sub_t) = run(), run(impl="ref")
            check(torch.equal(q, q_t) and torch.equal(sub, sub_t),
                  f"cat_split ({policy}) != its plain version: iteration {it}")
            fin = torch.isfinite(q_t)
            worst = max(worst, float((q[fin] - q_t[fin]).abs().max()))
        if it == 0:  # the plain version on the CPU gives the same bits
            q_c, sub_c = categorical_split(codes.cpu(), *(x.cpu() for x in tables["reg"]))
            q, sub = runs["reg"]()
            check(torch.equal(q.cpu(), q_c) and torch.equal(sub.cpu(), sub_c),
                  "cat_split != the plain version on the CPU")
    errs["cat_split"] = worst
    b, nn = codes.shape
    print(f"(t) check 1: cat_split on stage 0's LBP code block ({b} features x {nn} samples) "
          f"at 2 boosting iterations, regression, misclassification and Gini, bit for bit "
          f"equal to the plain version on the card (and on the CPU, regression, iteration 0); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reg, cls_t = tables["reg"], tables["class"]
    # the same shape with other code distributions: uniform (groups of 1-3
    # in a window of 32) and one code a feature (groups of 32)
    gen = torch.Generator(device=dev).manual_seed(0)
    dists = {"real": codes,
             "uniform": torch.randint(0, 256, (b, nn), device=dev, generator=gen,
                                      dtype=torch.int32),
             "one_code": (torch.arange(b, device=dev, dtype=torch.int32) % 256)[:, None]
             .expand(b, nn).contiguous()}
    for name, c in dists.items():
        check(all(torch.equal(x, y) for x, y in zip(categorical_split(c, *reg),
                                                    categorical_split(c, *reg, impl="ref"))),
              f"cat_split (regression) != its plain version on {name} codes")
    dist_ms = {name: cuda_ms(lambda c=c: categorical_split(c, *reg), 20)
               for name, c in dists.items()}
    lib_ms = cuda_ms(lambda: cat_library(codes, *reg, "reg"), 20)
    res = [r for r in _build.kernel_resources("cat_split.cu") if "cat_split_kernel" in r[0]]
    check(res, "no ptxas report for cat_split_kernel")
    print(f"(t) check 1: cat_split (regression) equal to its plain version on uniform and "
          f"one-code blocks too; kernel ms by codes: " + ", ".join(
              f"{k} {v:.4f} ({window_stats(c)} a window of 32)" for (k, v), c in zip(
                  dist_ms.items(), dists.values())) + f"; library composite on the real "
          f"block {lib_ms:.4f} ms ({gpu_info()}); ptxas: " + "; ".join(
              f"{regs} registers, {st} B spill stores, {ld} B spill loads"
              for _, regs, st, ld in res), flush=True)
    timed["cat_split"] = (lambda: categorical_split(codes, *reg),
                          lambda: categorical_split(codes, *reg, impl="ref"),
                          lambda: cat_library(codes, *reg, "reg"), 1)
    timed_extra["cat_split"] = {
        "misclass_ms": lambda: categorical_class_split(codes, *cls_t, False),
        "gini_ms": lambda: categorical_class_split(codes, *cls_t, True),
        "uniform_codes_ms": lambda: categorical_split(dists["uniform"], *reg),
        "one_code_ms": lambda: categorical_split(dists["one_code"], *reg)}
    # the codes and tables read once, the outputs written once; the
    # histograms' f64 adds (two a sample and feature) at the f64 rate
    work["cat_split"] = bound(b * nn * 4 + nn * 16 + b * (8 + 32), 2 * b * nn,
                              F64_OPS_PER_S)
    del calls

    # -- check 2: the first 3 stages of LBP training on the card
    t2 = time.perf_counter()
    mismatches = []
    full = os.path.join(TRAIN_DIR, "lbp")
    trainer = checked_trainer("t", mismatches, feature_type=FEATURE_LBP, device=dev)
    reset_timings()
    _build.LAUNCHES.clear()
    try:
        trainer.train(full, vec, bg, num_pos=1000, num_neg=2000, num_stages=20)
    except ThreeStages:
        pass
    torch.cuda.synchronize()
    launches["cat_split"] = _build.LAUNCHES.get("cat_split", 0)
    check(launches["cat_split"] > 0, "kernel cat_split was not launched on the main path")
    check_mine_launches("t", trainer, True)
    check(_build.LAUNCHES.get("split_scan_gather", 0) == 0,
          "LBP training launched the ordered split")
    check(len(trainer.stages) == 3, f"the LBP trainer trained {len(trainer.stages)} stages")
    check(all(m == 0 for m in mismatches), f"LBP accept masks differ from the CPU's: "
                                           f"{mismatches}")
    tm = timings()
    for si in range(3):
        per_stage = {k: tm[k][si] for k in ("fill_positives", "fill_negatives", "set_samples",
                                            "train_stage")}
        print(f"(t) stage {si}: {len(trainer.stages[si].trees)} trees, "
              f"{sum(per_stage.values()):.2f} s (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in per_stage.items()) +
              f"; {net_fill(tm, trainer, si)})", flush=True)
    n_trees = sum(len(st.trees) for st in trainer.stages)
    print(f"(t) check 2: 3 stages of a 20-stage LBP run (24x24, 8464 features in one block, "
          f"GAB stumps, weak_count 100, minHitRate 0.995, maxFalseAlarm 0.5, 1000 + 2000 "
          f"samples): {n_trees} trees, cat_split launched {launches['cat_split']} times; "
          f"train_stage {sum(tm['train_stage']) / n_trees:.4f} s a tree; "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    t3 = time.perf_counter()
    cpu_dir = os.path.join(TRAIN_DIR, "lbp_cpu")
    CascadeTrainer(feature_type=FEATURE_LBP, device="cpu").train(
        cpu_dir, vec, bg, num_pos=1000, num_neg=2000, num_stages=1, verbose=False)
    with open(os.path.join(full, "stage0.xml"), "rb") as a, \
            open(os.path.join(cpu_dir, "stage0.xml"), "rb") as c:
        card, host = a.read(), c.read()
    check(card == host, "LBP stage0.xml trained on the card differs from the CPU's")
    print(f"(t) check 2: stage 0 trained on the CPU at 1000 + 2000 samples: stage0.xml "
          f"byte-identical to the card's ({len(host)} bytes); "
          f"{time.perf_counter() - t3:.1f} s", flush=True)

    # -- check 3: the two-class policy of the split kernel on stage 0's Haar
    # blocks (DAB classes) at two boosting iterations, against its plain version
    t4 = time.perf_counter()
    haar = CascadeTrainer(device=dev)
    ev = haar.evaluator
    ev.set_samples(samples)
    calls = capture_splits(boost.StageTrainer(ev, boost.BoostParams(
        boost_type=BOOST_DAB, weak_count=2, max_false_alarm=0.0)), labels, valid)
    check(len(calls) == 2, f"DAB stage 0 took {len(calls)} split searches, expected 2")
    worst, full_block = 0.0, None
    cls_dev = torch.as_tensor(cls, device=dev)
    for it, (cache, w, _resp, mask) in enumerate(calls):
        wm = np.where(mask, w, 0.0)
        w0, w1 = np.where(cls, 0.0, wm), np.where(cls, wm, 0.0)
        t0c = tree_sum(w0)
        t1c = tree_sum(wm) - t0c
        wm_dev = torch.as_tensor(wm, device=dev)
        tabs = (torch.where(cls_dev, 0.0, wm_dev), torch.where(cls_dev, wm_dev, 0.0),
                torch.as_tensor(mask, device=dev), t0c, t1c)
        for b in range(cache.num_blocks):
            order, vs = cache.sorted_block(b)
            for gini in (False, True):
                q, thr = split_scan_class_gather(vs, order, *tabs, gini)
                q_t, thr_t = split_scan_class_gather(vs, order, *tabs, gini, impl="ref")
                check(torch.equal(q, q_t) and torch.equal(thr, thr_t),
                      f"split_scan_class_gather (gini {gini}) != its plain version: block {b}, "
                      f"iteration {it}")
                fin = torch.isfinite(q_t)
                worst = max(worst, float((q[fin] - q_t[fin]).abs().max()),
                            float((thr - thr_t).abs().max()))
            if full_block is None and vs.shape[1] == ev.block_size:
                full_block = (vs, order, tabs)
    errs["split_scan_class_gather"] = worst
    vs, order, tabs = full_block
    nn, nb = vs.shape
    # the trainer's layout past the budgets (torch.sort's (B, N) outputs seen
    # transposed) and the resident one (contiguous (N, B))
    vs_r, order_r = vs.contiguous(), order.contiguous()
    vs, order = vs_r.t().contiguous().t(), order_r.t().contiguous().t()
    print(f"(t) check 3: split_scan_class_gather on {cache.num_blocks} Haar blocks x 2 DAB "
          f"iterations ({nn} samples x up to {nb} features), misclassification and Gini, bit "
          f"for bit equal to the plain version on the card; {time.perf_counter() - t4:.1f} s",
          flush=True)
    timed["split_scan_class_gather"] = (
        lambda: split_scan_class_gather(vs, order, *tabs, False),
        lambda: split_scan_class_gather(vs, order, *tabs, False, impl="ref"),
        lambda: class_split_library(vs, tabs[0][order], tabs[1][order], tabs[2][order],
                                    *tabs[3:]), 1)
    # the design it replaces (split_scan.cu's two-class policy) on the same
    # block, in the same run
    t_old = time.perf_counter()
    old = {gini: lib for gini, (lib, _res) in scan_policy_kernels().items()}
    for gini, lib in old.items():
        for a in ((vs, order), (vs_r, order_r)):
            check(all(torch.equal(x, y) for x, y in zip(
                run_scan_policy(lib, *a, *tabs), split_scan_class_gather(*a, *tabs, gini))),
                f"split_scan.cu's two-class policy (gini {gini}) != split_scan_class_gather")
    res = [r for r in _build.kernel_resources("split_class.cu") if "split_class_kernel" in r[0]]
    check(res, "no ptxas report for split_class_kernel")
    # the instantiations: <gini, shared table>, of which this block takes the shared one
    res = {name: (regs, st, ld) for name, regs, st, ld in res}
    taken = {gini: next(v for k, v in res.items() if f"ILb{int(gini)}ELb1E" in k)
             for gini in (False, True)}
    values_extra["split_scan_class_gather"] = {
        "registers": taken[False][0], "spills": taken[False][1] + taken[False][2],
        "gini_registers": taken[True][0], "gini_spills": taken[True][1] + taken[True][2],
        "ctas_per_sm": ctas_per_sm(_build.lib(), nn, False),
        "gini_ctas_per_sm": ctas_per_sm(_build.lib(), nn, True)}
    print(f"(t) check 3: split_scan.cu's two-class policy rebuilt (utils/tune_split_class.py, "
          f"{time.perf_counter() - t_old:.1f} s) equal to split_scan_class_gather on the "
          f"{nn} x {nb} block, both policies and layouts; the kernel's ptxas reports: "
          f"{res}; resident "
          f"CTAs an SM {values_extra['split_scan_class_gather']['ctas_per_sm']} "
          f"(Gini {values_extra['split_scan_class_gather']['gini_ctas_per_sm']})", flush=True)
    timed_extra["split_scan_class_gather"] = {
        "gini_ms": lambda: split_scan_class_gather(vs, order, *tabs, True),
        "scan_policy_ms": lambda: run_scan_policy(old[False], vs, order, *tabs),
        "scan_policy_gini_ms": lambda: run_scan_policy(old[True], vs, order, *tabs),
        "resident_ms": lambda: split_scan_class_gather(vs_r, order_r, *tabs, False),
        "gini_resident_ms": lambda: split_scan_class_gather(vs_r, order_r, *tabs, True),
        "scan_policy_resident_ms": lambda: run_scan_policy(old[False], vs_r, order_r, *tabs),
        "scan_policy_gini_resident_ms": lambda: run_scan_policy(old[True], vs_r, order_r,
                                                                 *tabs)}
    work["split_scan_class_gather"] = bound(nn * nb * (4 + 8) + nn * (8 + 8 + 1) + nb * (8 + 4),
                                            0)
    del calls, cache

    # -- check 4: a DAB stage on the card and on the CPU, byte for byte
    t5 = time.perf_counter()
    outs = {}
    for where in (dev, "cpu"):
        d = os.path.join(TRAIN_DIR, f"dab_{torch.device(where).type}")
        _build.LAUNCHES.clear()
        CascadeTrainer(boost=boost.BoostParams(boost_type=BOOST_DAB), device=where).train(
            d, vec, bg, num_pos=200, num_neg=400, num_stages=1, verbose=False)
        if where == dev:
            launches["split_scan_class_gather"] = _build.LAUNCHES.get(
                "split_scan_class_gather", 0)
        with open(os.path.join(d, "stage0.xml"), "rb") as f:
            outs[where] = f.read()
    check(launches["split_scan_class_gather"] > 0,
          "kernel split_scan_class_gather was not launched on the DAB stage")
    check(outs[dev] == outs["cpu"], "DAB stage0.xml trained on the card differs from the CPU's")
    print(f"(t) check 4: a DAB stage at 200 positives + 400 negatives, trained on the card "
          f"(split_scan_class_gather launched {launches['split_scan_class_gather']} times) and "
          f"on the CPU: stage0.xml byte-identical ({len(outs['cpu'])} bytes); "
          f"{time.perf_counter() - t5:.1f} s", flush=True)
    print(f"(t) phase took {time.perf_counter() - t0:.1f} s", flush=True)


def trained_stage_times(tag: str, trainer, n: int):
    """Print each of the first n stages' trees, depth and phase times."""
    from cascadeclassifier_tpu_torch.train.predictor import _tree_depth
    from cascadeclassifier_tpu_torch.utils.profiling import timings

    tm = timings()
    for si in range(n):
        per_stage = {k: tm[k][si] for k in ("fill_positives", "fill_negatives", "set_samples",
                                            "train_stage")}
        trees = trainer.stages[si].trees
        print(f"({tag}) stage {si}: {len(trees)} trees of depth up to "
              f"{max(_tree_depth(t) for t in trees)}, {sum(per_stage.values()):.2f} s (" +
              ", ".join(f"{k} {v:.2f}" for k, v in per_stage.items()) +
              f"; fill_negatives holds {trainer.check_s[si]:.2f} s of the CPU's check; "
              f"{net_fill(tm, trainer, si)})",
              flush=True)
    return tm


def card_and_cpu_stage0(tag: str, dev, vec, bg, n_pos: int, n_neg: int, **kw):
    """Stage 0 trained on the card and on the CPU: (stage0.xml bytes, the
    card's kernel launches)."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer

    outs = {}
    for where in (dev, "cpu"):
        d = os.path.join(TRAIN_DIR, f"{tag}_{torch.device(where).type}")
        _build.LAUNCHES.clear()
        CascadeTrainer(device=where, **kw).train(d, vec, bg, num_pos=n_pos, num_neg=n_neg,
                                                 num_stages=1, verbose=False)
        if where == dev:
            torch.cuda.synchronize()
            card_launches = dict(_build.LAUNCHES)
        with open(os.path.join(d, "stage0.xml"), "rb") as f:
            outs[where] = f.read()
    check(outs[dev] == outs["cpu"], f"({tag}) stage0.xml trained on the card differs from "
                                    f"the CPU's")
    return outs["cpu"], card_launches


def deep_phase(dev, vec, bg, launches, values_extra):
    """(u): weak trees of depth 2 (-maxDepth 2) on (s)'s data: the three
    split kernels under node masks that are no tree root's; see the module
    docstring."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.models.model import BOOST_DAB, FEATURE_LBP
    from cascadeclassifier_tpu_torch.train.boost import BoostParams
    from cascadeclassifier_tpu_torch.utils.profiling import reset_timings

    t0 = time.perf_counter()
    mismatches = []
    trainer = checked_trainer("u", mismatches, boost=BoostParams(max_depth=2), device=dev)
    reset_timings()
    _build.LAUNCHES.clear()
    try:
        trainer.train(os.path.join(TRAIN_DIR, "deep"), vec, bg, num_pos=1000, num_neg=2000,
                      num_stages=20)
    except ThreeStages:
        pass
    torch.cuda.synchronize()
    n_gather = _build.LAUNCHES.get("split_scan_gather", 0)
    check(n_gather > 0, "kernel split_scan_gather was not launched on the depth-2 path")
    check_mine_launches("u", trainer, False)
    check(len(trainer.stages) == 3, f"the depth-2 trainer trained {len(trainer.stages)} stages")
    check(all(m == 0 for m in mismatches), f"depth-2 accept masks differ from the CPU's: "
                                           f"{mismatches}")
    check(any(t.num_nodes >= 2 for st in trainer.stages for t in st.trees),
          "no tree of the depth-2 run split below its root")
    tm = trained_stage_times("u", trainer, 3)
    trees = [t for st in trainer.stages for t in st.trees]
    splits = sum(t.num_nodes for t in trees)
    values_extra["split_scan_gather"] = {"launches_depth2": n_gather,
                                         "launches_depth2_per_tree": n_gather / len(trees)}
    print(f"(u) check 1: 3 stages of a 20-stage Haar BASIC GAB run at max_depth 2 (weak_count "
          f"100, minHitRate 0.995, maxFalseAlarm 0.5, 1000 + 2000 samples): {len(trees)} trees, "
          f"{splits} split nodes; split_scan_gather launched {n_gather} times "
          f"({n_gather / len(trees):.1f} a tree); train_stage "
          f"{sum(tm['train_stage']) / len(trees):.4f} s a tree; each first mining superbatch "
          f"equal to the CPU's; {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    runs = (("haar_d2", "split_scan_gather", 200, 400, dict(boost=BoostParams(max_depth=2))),
            ("dab_d2", "split_scan_class_gather", 200, 400,
             dict(boost=BoostParams(boost_type=BOOST_DAB, max_depth=2))),
            ("lbp_d2", "cat_split", 1000, 2000,
             dict(feature_type=FEATURE_LBP, boost=BoostParams(max_depth=2))))
    for tag, kernel, n_pos, n_neg, kw in runs:
        t2 = time.perf_counter()
        xml, card = card_and_cpu_stage0(tag, dev, vec, bg, n_pos, n_neg, **kw)
        n_launch = card.get(kernel, 0)
        check(n_launch > 0, f"({tag}) kernel {kernel} was not launched")
        n_trees = xml.count(b"<internalNodes>")
        if kernel != "split_scan_gather":
            values_extra.setdefault(kernel, {}).update({
                "launches_depth2": n_launch,
                "launches_depth2_per_tree": n_launch / max(n_trees, 1)})
        print(f"(u) check 2: {tag} stage 0 at {n_pos} + {n_neg} samples on the card and on the "
              f"CPU: stage0.xml byte-identical ({len(xml)} bytes, {n_trees} trees, "
              f"{kernel} launched {n_launch} times); "
              f"{time.perf_counter() - t2:.1f} s", flush=True)
    print(f"(u) phase took {time.perf_counter() - t0:.1f} s", flush=True)


def hog_library(x):
    """The integral histograms as library calls (torch.atan2, a one-hot,
    two torch.cumsum), for its time only: neither the root nor the sums
    are in the JAX package's order."""
    xf = x.to(torch.float32)
    dx = torch.nn.functional.pad(xf[:, None], (1, 1, 0, 0), mode="replicate")[:, 0]
    dy = torch.nn.functional.pad(xf[:, None], (0, 0, 1, 1), mode="replicate")[:, 0]
    gx, gy = dx[:, :, 2:] - dx[:, :, :-2], dy[:, 2:] - dy[:, :-2]
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    ang = torch.where(ang < 0, ang + 2 * np.pi, ang)
    b = torch.remainder(torch.floor(ang * (9 / np.pi) - 0.5).long(), 9)
    per_bin = torch.nn.functional.one_hot(b, 9).permute(0, 3, 1, 2) * mag[:, None]

    def ii(v):
        return torch.nn.functional.pad(torch.cumsum(torch.cumsum(v, -1), -2), (1, 0, 1, 0))

    return ii(per_bin), ii(mag)


def hog_eval_library(hist, norm, m_cells, m_norm, n):
    """The responses as the JAX evaluator forms them: the ±1 corner
    matrices times the flattened histograms (f32 torch.matmul, TF32 off),
    the division and the select; for its time only."""
    cs = m_cells @ hist.reshape(n * 9, -1).t()  # (4F, 9N)
    nm = m_norm @ norm.t()  # (F, N)
    cs = cs.view(m_norm.shape[0], 4, n, 9)
    return torch.where(cs > 1e-3, cs / (nm[:, None, :, None] + 1e-3), 0.0)


def hog_matrices(cells, p: int, dev):
    """(cell corner matrix (4F, P), norm corner matrix (F, P)) f32 ±1."""
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], device=dev)
    f = cells.shape[0]
    m_cells = torch.zeros((f * 4, p), device=dev)
    m_cells.index_put_((torch.arange(f * 4, device=dev).repeat_interleave(4),
                        cells.reshape(-1).long()), sign.repeat(f * 4), accumulate=True)
    diag = torch.arange(4, device=dev)
    m_norm = torch.zeros((f, p), device=dev)
    m_norm.index_put_((torch.arange(f, device=dev).repeat_interleave(4),
                       cells[:, diag, diag].reshape(-1).long()), sign.repeat(f), accumulate=True)
    return m_cells, m_norm


def hog_eval_sector_bytes(cells, ids, n: int, p: int) -> int:
    """Bytes of the 32-byte sectors of hist (n, 9, p) and norm (n, p), f32,
    each from an aligned base, that hold a corner hog_eval reads for the
    variables ids: the histogram corners of each variable's cell and bin,
    the norm's block corners."""
    cells, ids = cells.cpu().numpy().astype(np.int64), ids.cpu().numpy()
    f, cell, b = ids // 36, ids % 36 // 9, ids % 9
    hist_pts = np.unique(b[:, None] * p + cells[f, cell], axis=None)  # plane · p + offset
    diag = np.arange(4)
    norm_pts = np.unique(cells[np.unique(f)][:, diag, diag])
    sample = np.arange(n, dtype=np.int64)[:, None]
    hist_sec = np.unique((sample * 9 * p + hist_pts[None]) * 4 // 32)
    norm_sec = np.unique((sample * p + norm_pts[None]) * 4 // 32)
    return (len(hist_sec) + len(norm_sec)) * 32


def hog_bounds(n: int, side: int, cells, ids):
    """(hog_hist's bound, hog_eval's bound) on n windows of side x side and
    the variables ids."""
    px, p = side * side, (side + 1) ** 2
    # hog_hist: the windows and the bin table read once, 10 integrals written;
    # per pixel 2 subtractions, 2 products, a sum, a root, 10 one-hot selects
    # and 2 adds a channel (the two scans)
    hist = bound(n * px + 511 * 511 + n * 10 * p * 4, n * px * (6 + 10 + 20))
    # hog_eval: of the histograms and norms only the corners its variables
    # name, in whole 32-byte sectors; the corner table and ids read once,
    # the (vars, samples) responses written once; 6 adds, an add, a
    # division and a compare an output
    k = int(ids.numel())
    resp = bound(hog_eval_sector_bytes(cells, ids, n, p) + cells.numel() * 4 + k * 8 + k * n * 4,
                 k * n * 9)
    return hist, resp


def hog_phase(dev, vec, bg, timed, work, errs, launches, timed_extra, values_extra):
    """(v): HOG on (s)'s data: the two kernels on stage 0's samples and the
    edge windows, 3 stages of HOG training, detection with the trained
    cascade at 1080p; see the module docstring."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.data.vec import PosReader
    from cascadeclassifier_tpu_torch.detect.grouping import clip_rects, group_rectangles
    from cascadeclassifier_tpu_torch.detect.hog_detector import HOGDetector
    from cascadeclassifier_tpu_torch.detect.pyramid import build_plan
    from cascadeclassifier_tpu_torch.models.model import FEATURE_HOG
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml, write_cascade_xml
    from cascadeclassifier_tpu_torch.ops.features import hog_catalog
    from cascadeclassifier_tpu_torch.ops.hog import hog_integral_histogram, hog_responses
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer
    from cascadeclassifier_tpu_torch.utils.edges import hog_edge_mismatches
    from cascadeclassifier_tpu_torch.utils.profiling import reset_timings, timings
    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    t0 = time.perf_counter()
    tr = CascadeTrainer(feature_type=FEATURE_HOG, device=dev)
    pos = tr._fill_positives(PosReader(vec, 24, 24), 1000, [0])
    neg = tr._fill_negatives(NegReader(bg, 24, 24, lazy=True), 2000, 0.0, [0])
    s24 = torch.from_numpy(np.concatenate([pos, neg, np.zeros((72, 24, 24), np.uint8)])).to(dev)
    s32 = torch.nn.functional.interpolate(s24[:, None].float(), size=(32, 32), mode="bilinear",
                                          align_corners=False).round().clamp(0, 255)
    s32 = s32[:, 0].to(torch.uint8).contiguous()
    worst = {"hog_hist": 0.0, "hog_eval": 0.0}
    inputs = {}
    for side, x in ((24, s24), (32, s32)):
        n = x.shape[0]
        (h, nm), (h_t, nm_t) = hog_integral_histogram(x), hog_integral_histogram(x, impl="ref")
        check(torch.equal(h, h_t) and torch.equal(nm, nm_t),
              f"hog_hist != its plain version at {side}x{side}")
        cat = hog_catalog(side, side)
        cells = torch.from_numpy(cat.cell_corner_offsets()).to(dev)
        ids = torch.arange(cat.var_count, device=dev)
        flat = (h.reshape(n, 9, -1), nm.reshape(n, -1))
        r, r_t = hog_responses(*flat, cells, ids), hog_responses(*flat, cells, ids, impl="ref")
        check(torch.equal(r, r_t), f"hog_eval != its plain version at {side}x{side}")
        worst["hog_hist"] = max(worst["hog_hist"], float((h - h_t).abs().max()),
                                float((nm - nm_t).abs().max()))
        worst["hog_eval"] = max(worst["hog_eval"], float((r - r_t).abs().max()))
        h_c, nm_c = hog_integral_histogram(x.cpu())
        check(torch.equal(h.cpu(), h_c) and torch.equal(nm.cpu(), nm_c),
              f"hog_hist != the plain version on the CPU at {side}x{side}")
        inputs[side] = (x, flat, cells, ids, cat)
    errs.update(worst)
    n_edge, bad = hog_edge_mismatches(dev)
    check(not bad, f"HOG kernels differ from their plain versions on edge windows: {bad}")
    print(f"(v) check 1: hog_hist and hog_eval (every variable) on stage 0's 3072 samples at "
          f"24x24 (9 features) and resized to 32x32 (36 features, cells of 16), and on {n_edge}"
          f" edge-window sets (utils/edges.py::hog_edge_cases), bit for bit equal to their "
          f"plain versions on the card (hog_hist also to the CPU's); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x, flat, cells, ids, cat = inputs[24]
    n = x.shape[0]
    m_cells, m_norm = hog_matrices(cells, flat[1].shape[1], dev)
    timed["hog_hist"] = (lambda: hog_integral_histogram(x),
                         lambda: hog_integral_histogram(x, impl="ref"),
                         lambda: hog_library(x), 3)
    timed["hog_eval"] = (lambda: hog_responses(*flat, cells, ids),
                         lambda: hog_responses(*flat, cells, ids, impl="ref"),
                         lambda: hog_eval_library(*flat, m_cells, m_norm, n), 3)
    work["hog_hist"], work["hog_eval"] = hog_bounds(n, 24, cells, ids)
    x32, flat32, cells32, ids32, _ = inputs[32]
    b32 = hog_bounds(x32.shape[0], 32, cells32, ids32)
    timed_extra["hog_hist"] = {"ms_32x32": lambda: hog_integral_histogram(x32)}
    timed_extra["hog_eval"] = {"ms_32x32": lambda: hog_responses(*flat32, cells32, ids32)}
    values_extra["hog_hist"] = {"bound_ms_32x32": b32[0][0], "device_ms": device_ms(
        lambda: hog_integral_histogram(x), ["hog_hist_kernel"])["hog_hist_kernel"]}
    dev_eval = device_ms(lambda: hog_responses(*flat, cells, ids),
                                ["hog_eval_plan_kernel", "hog_eval_kernel"])
    values_extra["hog_eval"] = {"bound_ms_32x32": b32[1][0],
                                "device_ms_plan": dev_eval["hog_eval_plan_kernel"],
                                "device_ms_gather": dev_eval["hog_eval_kernel"]}

    # -- check 2: 3 stages of HOG training on the card, first superbatches
    # against the CPU's, stage 0 byte for byte
    t2 = time.perf_counter()
    mismatches = []
    trainer = checked_trainer("v", mismatches, feature_type=FEATURE_HOG, device=dev)
    reset_timings()
    _build.LAUNCHES.clear()
    full = os.path.join(TRAIN_DIR, "hog")
    try:
        trainer.train(full, vec, bg, num_pos=1000, num_neg=2000, num_stages=20)
    except ThreeStages:
        pass
    torch.cuda.synchronize()
    launches["hog_hist"] = _build.LAUNCHES.get("hog_hist", 0)
    launches["hog_eval"] = _build.LAUNCHES.get("hog_eval", 0)
    check(launches["hog_hist"] > 0 and launches["hog_eval"] > 0,
          f"HOG training launched hog_hist {launches['hog_hist']} and hog_eval "
          f"{launches['hog_eval']} times")
    check(len(trainer.stages) == 3, f"the HOG trainer trained {len(trainer.stages)} stages")
    check_mine_launches("v", trainer, False)
    check(all(m == 0 for m in mismatches), f"HOG accept masks differ from the CPU's: "
                                           f"{mismatches}")
    tm = trained_stage_times("v", trainer, 3)
    n_trees = sum(len(st.trees) for st in trainer.stages)
    print(f"(v) check 2: 3 stages of a 20-stage HOG run (24x24, 9 features x 36 variables, "
          f"GAB stumps, 1000 + 2000 samples): {n_trees} trees; hog_hist launched "
          f"{launches['hog_hist']} times, hog_eval {launches['hog_eval']}; train_stage "
          f"{sum(tm['train_stage']) / n_trees:.4f} s a tree; each first mining superbatch "
          f"equal to the CPU's; {time.perf_counter() - t2:.1f} s", flush=True)
    t3 = time.perf_counter()
    xml, _ = card_and_cpu_stage0("hog", dev, vec, bg, 1000, 2000, feature_type=FEATURE_HOG)
    print(f"(v) check 2: HOG stage 0 at 1000 + 2000 samples on the card and on the CPU: "
          f"stage0.xml byte-identical ({len(xml)} bytes); {time.perf_counter() - t3:.1f} s",
          flush=True)

    # -- check 3: detection with the trained cascade at 1080p
    t4 = time.perf_counter()
    write_cascade_xml(trainer._to_model(), os.path.join(full, "cascade.xml"))
    model = read_cascade_xml(os.path.join(full, "cascade.xml"))
    check(model.feat_size == 36 and model.feature_type == FEATURE_HOG and
          model.num_stages == 3, "the HOG cascade.xml does not read back as 3 HOG stages")
    frame = synth_frame(0)
    det = HOGDetector(model, device=dev)
    det.detect_multi_scale(frame, 1.1, 3)  # warm-up
    _build.LAUNCHES.clear()
    t5 = time.perf_counter()
    rects = det.detect_multi_scale(frame, 1.1, 3)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t5) * 1e3
    det_launches = dict(_build.LAUNCHES)
    raw, n_windows = det.raw_windows(frame, 1.1)
    want_raw, want_windows = HOGDetector(model, device=dev, impl="ref").raw_windows(frame, 1.1)
    check(n_windows == want_windows and np.array_equal(raw, want_raw),
          f"HOG detection: the kernels' {len(raw)} raw candidates of {n_windows} windows differ "
          f"from the plain-version path's {len(want_raw)} of {want_windows}")
    want = clip_rects(group_rectangles(want_raw, 3), frame.shape[1], frame.shape[0])
    check(np.array_equal(np.asarray(rects).reshape(-1, 4), np.asarray(want).reshape(-1, 4)),
          "HOG detection: the kernels' rects differ from the plain-version path's")
    check(det_launches.get("hog_hist", 0) > 0 and det_launches.get("hog_eval", 0) > 0,
          "HOG detection did not launch both HOG kernels")
    values_extra["hog_hist"]["launches_detect_frame"] = det_launches.get("hog_hist", 0)
    values_extra["hog_eval"]["launches_detect_frame"] = det_launches.get("hog_eval", 0)
    print(f"(v) check 3: HOG detection on synth_frame(0) at 1080p, sf 1.1, minNeighbors 3: "
          f"{n_windows} windows, {len(raw)} raw candidates, {len(rects)} rects, the raw "
          f"candidates and the rects equal to the plain-version path's; {ms:.1f} ms a frame "
          f"({gpu_info()}); hog_hist launched "
          f"{det_launches.get('hog_hist', 0)} times, hog_eval {det_launches.get('hog_eval', 0)}"
          f"; {time.perf_counter() - t4:.1f} s", flush=True)

    # -- check 4: both kernels on the detector's first batch (level 0's
    # first 8 192 windows) and the cascade's used variables
    plan = build_plan(frame.shape[1], frame.shape[0], 24, 24, 1.1, None, None)
    step = int(plan.ystep[0])
    xb = torch.from_numpy(frame).to(dev).unfold(0, 24, step).unfold(1, 24, step)
    xb = xb.reshape(-1, 24, 24)[:det.batch].contiguous()
    used = torch.as_tensor(det._pred._walk_of(det._ev)[0], dtype=torch.int64, device=dev)
    nb = xb.shape[0]
    (hb, nmb), (hb_t, nmb_t) = hog_integral_histogram(xb), hog_integral_histogram(xb, impl="ref")
    check(torch.equal(hb, hb_t) and torch.equal(nmb, nmb_t),
          "hog_hist != its plain version on the detector's batch")
    flat_b = (hb.reshape(nb, 9, -1), nmb.reshape(nb, -1))
    check(torch.equal(hog_responses(*flat_b, cells, used),
                      hog_responses(*flat_b, cells, used, impl="ref")),
          "hog_eval != its plain version on the detector's batch")
    bb = hog_bounds(nb, 24, cells, used)
    timed_extra["hog_hist"]["ms_detector_batch"] = lambda: hog_integral_histogram(xb)
    timed_extra["hog_eval"]["ms_detector_batch"] = lambda: hog_responses(*flat_b, cells, used)
    values_extra["hog_hist"]["bound_ms_detector_batch"] = bb[0][0]
    values_extra["hog_eval"]["bound_ms_detector_batch"] = bb[1][0]
    values_extra["hog_hist"]["device_ms_detector_batch"] = device_ms(
        lambda: hog_integral_histogram(xb), ["hog_hist_kernel"])["hog_hist_kernel"]
    values_extra["hog_eval"]["device_ms_detector_batch"] = sum(device_ms(
        lambda: hog_responses(*flat_b, cells, used),
        ["hog_eval_plan_kernel", "hog_eval_kernel", "hog_eval_direct_kernel"]).values())
    values_extra["hog_eval"]["vars_detector_batch"] = int(used.numel())
    print(f"(v) check 4: hog_hist and hog_eval ({used.numel()} used variables) on the detector's"
          f" first batch of {nb} windows at 24x24 equal to their plain versions", flush=True)
    print(f"(v) phase took {time.perf_counter() - t0:.1f} s", flush=True)


N_POS, N_NEG = 1000, 2000  # the samples of a stage in (w) and (x), as in (s)


def stage0_samples(dev, vec, bg, evaluator):
    """Stage 0's samples of (s)'s data (N_POS positives + N_NEG negatives,
    padded to a multiple of 256 as the trainer pads them) set on evaluator
    → (labels, valid)."""
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.data.vec import PosReader
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer

    tr = CascadeTrainer(device=dev)
    pos = tr._fill_positives(PosReader(vec, 24, 24), N_POS, [0])
    neg = tr._fill_negatives(NegReader(bg, 24, 24, lazy=True), N_NEG, 0.0, [0])
    n = N_POS + N_NEG
    n_pad = -(-n // 256) * 256
    evaluator.set_samples(np.concatenate([pos, neg, np.zeros((n_pad - n, 24, 24), np.uint8)]))
    labels = np.concatenate([np.ones(N_POS, np.int32), np.zeros(n_pad - N_POS, np.int32)])
    return labels, np.arange(n_pad) < n


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_stage0(tag: str, dev, vec, bg, mesh=None, **kw):
    """Stage 0 trained at N_POS + N_NEG samples on dev, over mesh when given
    → (stage0.xml bytes, the seconds its phases took, the kernels'
    launches in the run)."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer
    from cascadeclassifier_tpu_torch.utils.profiling import reset_timings, timings

    d = os.path.join(TRAIN_DIR, tag)
    reset_timings()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    CascadeTrainer(device=dev, mesh=mesh, **kw).train(d, vec, bg, num_pos=N_POS, num_neg=N_NEG,
                                                      num_stages=1, verbose=False)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    with open(os.path.join(d, "stage0.xml"), "rb") as f:
        return f.read(), {k: v[0] for k, v in timings().items()}, counts


def multi_device_phase(dev, vec, bg, values_extra):
    """(w): the feature-sharded split search and trainer over 4 shards on
    the card, two processes joined by gloo, a one-rank NCCL group and the
    dry run; see the module docstring."""
    import subprocess

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.models.model import BOOST_DAB, FEATURE_LBP
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.parallel.dryrun import dryrun_multichip
    from cascadeclassifier_tpu_torch.parallel.sharded import (
        init_distributed,
        make_mesh,
        process_mesh,
        shard_features,
        sharded_ordered_best_split,
    )
    from cascadeclassifier_tpu_torch.train.boost import BoostParams, best_of_block
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator
    from cascadeclassifier_tpu_torch.train.split import split_scan_gather, tree_sum

    t0 = time.perf_counter()
    smi = gpu_info()
    mesh = make_mesh(4, devices=[dev] * 4)

    # -- check 1: the sharded split search on a real stage-0 block
    ev = HaarTrainEvaluator(haar_catalog(24, 24, "BASIC"), device=dev)
    labels, valid = stage0_samples(dev, vec, bg, ev)
    values = ev.values_block(0)
    vs_bn, si_bn = torch.sort(values, dim=1, stable=True)
    resp = labels * 2.0 - 1.0
    rng = np.random.default_rng(11)
    answers = {}
    for name, w in (("uniform", np.where(valid, 1.0 / valid.sum(), 0.0)),
                    ("reweighted", np.where(valid, rng.uniform(0.2, 1.0, valid.size), 0.0))):
        wm = np.where(valid, w, 0.0)
        tw, tr = tree_sum(wm), tree_sum(wm * resp)
        q, thr = split_scan_gather(vs_bn.t(), si_bn.t(), torch.as_tensor(wm, device=dev),
                                   torch.as_tensor(wm * resp, device=dev),
                                   torch.as_tensor(valid, device=dev), tw, tr)
        qm, i = best_of_block(q)
        want = (float(qm), int(i), np.float32(thr[i].item()))
        vs, si = shard_features(mesh, values, si_bn)
        fn = sharded_ordered_best_split(mesh)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        got = fn(vs, si, w, resp, valid)
        n_launch = _build.LAUNCHES["split_scan_gather"]
        check(got == want, f"(w) check 1 ({name}): sharded split {got} != one block's {want}")
        check(n_launch >= 4, f"(w) check 1: split_scan_gather launched {n_launch} times, not "
                             f"once a shard")
        answers[name] = (want, fn, (vs, si, w, resp, valid))
        print(f"(w) check 1 ({name} weights): the split over 4 shards of 8192 rows on {dev} "
              f"equals split_scan_gather + best_of_block over block 0 (32768 features x "
              f"{valid.size} samples) bit for bit: quality {want[0]!r}, feature {want[1]}, "
              f"threshold {float(want[2])!r}; split_scan_gather launched {n_launch} times",
              flush=True)
    want, fn, args = answers["reweighted"]
    values_extra["split_scan_gather"].update({
        "launches_sharded_split": n_launch,
        "ms_sharded_split_4_shards": cuda_ms(lambda: fn(*args), 10)})
    print(f"(w) check 1: the sharded search (4 shards, the combine on the host) "
          f"{values_extra['split_scan_gather']['ms_sharded_split_4_shards']:.4f} ms ({smi})",
          flush=True)

    # -- check 2: stage 0 over 4 shards on the card = the unsharded stage 0,
    # trained in the order unsharded, sharded, sharded, unsharded
    runs = (("haar", "split_scan_gather", {}),
            ("lbp", "cat_split", dict(feature_type=FEATURE_LBP)),
            ("dab_d2", "split_scan_class_gather",
             dict(boost=BoostParams(boost_type=BOOST_DAB, max_depth=2))))
    unsharded = {}
    for tag, kernel, kw in runs:
        xml, times = {}, {"one": [], "four": []}
        for k, (name, m) in enumerate((("one", None), ("four", mesh), ("four", mesh),
                                       ("one", None))):
            got, t, counts = train_stage0(f"w_{tag}_{k}", dev, vec, bg, mesh=m, **kw)
            check(xml.setdefault("stage0", got) == got,
                  f"(w) check 2 ({tag}): stage0.xml of run {k} ({name}) differs from run 0's")
            times[name].append(t)
            if m is not None:
                n_launch = counts.get(kernel, 0)
                check(n_launch >= 4, f"(w) check 2 ({tag}): {kernel} launched {n_launch} times")
        one = unsharded[tag] = xml["stage0"]
        values_extra.setdefault(kernel, {})[f"launches_sharded_stage0_{tag}"] = n_launch

        def fmt(ts):
            return " / ".join(f"{sum(t.values()):.3f} (train_stage {t['train_stage']:.3f})"
                              for t in ts)

        print(f"(w) check 2 ({tag}): stage 0 at {N_POS} + {N_NEG} samples over 4 shards on {dev}: "
              f"stage0.xml byte-identical to the unsharded run's ({len(one)} bytes, "
              f"{one.count(b'<internalNodes>')} trees), {kernel} launched {n_launch} times; "
              f"s/stage sharded {fmt(times['four'])}, unsharded {fmt(times['one'])} ({smi})",
              flush=True)

    # -- check 3: two processes on the card, joined by gloo
    t3 = time.perf_counter()
    coord = f"127.0.0.1:{free_port()}"
    reports = [os.path.join(TRAIN_DIR, f"w_rank{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cascadeclassifier_tpu_torch.parallel.dryrun", "--rank", str(i),
         "--world", "2", "--coordinator", coord, "--out", reports[i], "--device", str(dev),
         "--backend", "gloo", "--what", "train", "--vec", vec, "--bg", bg, "--num-pos",
         str(N_POS), "--num-neg", str(N_NEG), "--data", os.path.join(TRAIN_DIR, f"w_rank{i}")],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    check(all(p.returncode == 0 for p in procs), "(w) check 3: a rank failed:\n" + "\n".join(logs))
    stages = []
    for path in reports:
        with open(path) as f:
            stages.append(json.load(f)["stage0_xml"].encode())
    with open(os.path.join(TRAIN_DIR, "w_rank0", "stage0.xml"), "rb") as f:
        written = f.read()
    check(written == unsharded["haar"] and stages == [written, written],
          "(w) check 3: the two ranks' stage 0 differs from the one-process stage0.xml")
    check(not os.path.exists(os.path.join(TRAIN_DIR, "w_rank1")), "(w) check 3: rank 1 wrote")
    print(f"(w) check 3: two processes on {dev} joined by gloo train stage 0: both return the "
          f"one-process stage, rank 0 writes its stage0.xml byte for byte, rank 1 writes "
          f"nothing; {time.perf_counter() - t3:.1f} s", flush=True)

    # -- check 4: a one-rank NCCL group combines on the card
    want, _fn, (vs, si, w, resp, valid) = answers["reweighted"]
    nccl = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device=dev)
    with process_mesh(nccl):
        got = sharded_ordered_best_split(nccl)(values, si_bn, w, resp, valid)
    check(got == want, f"(w) check 4: the NCCL combine {got} != {want}")
    print(f"(w) check 4: a one-rank NCCL group's all_gather of CUDA records gives check 1's "
          f"split", flush=True)

    # -- check 5: the dry run
    out = dryrun_multichip(8)
    print(f"(w) check 5: dryrun_multichip(8) on {', '.join(out['devices'])}", flush=True)
    print(f"(w) phase took {time.perf_counter() - t0:.1f} s", flush=True)


def tools_phase(dev, vec, bg, frontal, frame0, golden, values_extra):
    """(x): the traincascade and detect CLIs on the card, a HOG cascade
    routed by the detect CLI, and a trace of one detection frame; see the
    module docstring."""
    import contextlib
    import io
    import shutil

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.detect.detector import make_detector
    from cascadeclassifier_tpu_torch.models.model import (
        FEATURE_HOG,
        CascadeModel,
        HOGFeature,
        Stage,
        WeakTree,
    )
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml, write_cascade_xml
    from cascadeclassifier_tpu_torch.ops.features import hog_catalog
    from cascadeclassifier_tpu_torch.tools import detect_cli, traincascade_cli
    from cascadeclassifier_tpu_torch.utils import train_data
    from cascadeclassifier_tpu_torch.utils.profiling import trace

    def stdout_of(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        check(rc == 0, f"(x) {fn.__module__} {argv} returned {rc}")
        return buf.getvalue()

    t0 = time.perf_counter()
    # -- check 1: torch-traincascade, 2 stages on the card
    data = os.path.join(TRAIN_DIR, "x_cli")
    _build.LAUNCHES.clear()
    # a leaf target of 0.1^2: the default 0.5^2 ends the run at stage 1's first windows
    out = stdout_of(traincascade_cli.main, ["-data", data, "-vec", vec, "-bg", bg, "-numPos",
                                             str(N_POS), "-numNeg", str(N_NEG), "-numStages",
                                             "2", "-maxFalseAlarmRate", "0.1", "-device",
                                             str(dev)])
    torch.cuda.synchronize()
    n_launch = _build.LAUNCHES["split_scan_gather"]
    check("Number of unique features given windowSize [24,24] : 162336" in out
          and "===== TRAINING 1-stage =====" in out, "(x) check 1: the CLI's transcript")
    check(n_launch > 0, "(x) check 1: the CLI did not launch split_scan_gather")
    model = read_cascade_xml(os.path.join(data, "cascade.xml"))
    check(model.num_stages == 2, f"(x) check 1: cascade.xml holds {model.num_stages} stages")
    scene = train_data.background(1080, 1920, seed=300)
    got = make_detector(model, device=dev).detect_multi_scale(scene, 1.1, 3)
    want = make_detector(model, device=dev, impl="ref").detect_multi_scale(scene, 1.1, 3)
    check(np.array_equal(got, want) and got.ndim == 2 and got.shape[1] == 4,
          "(x) check 1: the trained cascade's rects differ from the plain-version path's")
    values_extra["split_scan_gather"]["launches_cli_2_stages"] = n_launch
    print(f"(x) check 1: torch-traincascade trained 2 stages on the card (split_scan_gather "
          f"launched {n_launch} times); cascade.xml loads and detects {len(got)} rects on a "
          f"1080p clutter frame, equal to the plain-version path's", flush=True)

    # -- check 2: torch-detect on frame 0 prints the golden's rects
    pgm = os.path.join(TRAIN_DIR, "x_frame0.pgm")
    train_data.write_pgm(pgm, frame0)
    _build.LAUNCHES.clear()
    out = stdout_of(detect_cli.main, [frontal, pgm, "--scale-factor", "1.1", "--min-neighbors",
                                      "3", "--device", str(dev)])
    torch.cuda.synchronize()
    rects = sorted([int(v) for v in line.split()] for line in out.splitlines())
    g0 = next(g for g in golden["frames"] if g["k"] == 0)
    check(rects == g0["rects_mn3"], f"(x) check 2: torch-detect printed {len(rects)} rects, "
                                    f"the golden has {len(g0['rects_mn3'])}")
    check(_build.LAUNCHES["front"] > 0, "(x) check 2: torch-detect did not launch front")
    cat = hog_catalog(32, 32)
    tree = WeakTree(left=np.array([-1], np.int32), right=np.array([-2], np.int32),
                    feature_idx=np.array([0], np.int32), threshold=np.array([0.5], np.float32),
                    leaf_values=np.array([0.0, -1.0, 1.0], np.float32))
    hog = CascadeModel(feature_type=FEATURE_HOG, width=32, height=32,
                       stages=[Stage(threshold=-10.0, trees=[tree])],
                       features=[HOGFeature(rect=tuple(int(v) for v in cat.rects[0]),
                                            component=0)], feat_size=36).validate()
    hog_xml = os.path.join(TRAIN_DIR, "x_hog.xml")
    write_cascade_xml(hog, hog_xml)
    small = os.path.join(TRAIN_DIR, "x_small.pgm")
    train_data.write_pgm(small, frame0[:120, :160])
    _build.LAUNCHES.clear()
    lines = stdout_of(detect_cli.main, [hog_xml, small, "--scale-factor", "1.2",
                                        "--min-neighbors", "1", "--device", str(dev)]).splitlines()
    torch.cuda.synchronize()
    check(len(lines) >= 1 and _build.LAUNCHES["hog_hist"] > 0 and _build.LAUNCHES["hog_eval"] > 0,
          "(x) check 2: torch-detect did not route the HOG cascade through its kernels")
    print(f"(x) check 2: torch-detect on synth frame 0 (frontal face, sf 1.1, minNeighbors 3) "
          f"prints the {len(rects)} rects of the OpenCV golden; an accept-all HOG cascade goes "
          f"to HOGDetector ({len(lines)} rects, hog_hist and hog_eval launched)", flush=True)

    # -- check 3: a trace of one detection frame
    det = make_detector(read_cascade_xml(frontal), device=dev, exact=False)
    det.detect_multi_scale(frame0, 1.1, 3)  # warm-up
    log = os.path.join(TRAIN_DIR, "x_trace")
    with trace(log):
        det.detect_multi_scale(frame0, 1.1, 3)
        torch.cuda.synchronize()
    files = os.listdir(log)
    check(len(files) == 1, f"(x) check 3: trace files {files}")
    with open(os.path.join(log, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    check("detect.frame" in names, "(x) check 3: the frame's span is not in the trace")
    check(any("tile_kernel" in k for k in kernels),
          "(x) check 3: the front's kernel (tile_kernel) is not in the trace")
    device_ms = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3
    print(f"(x) check 3: trace() around one frame wrote {files[0]} "
          f"({os.path.getsize(os.path.join(log, files[0]))} bytes, {len(events)} events, "
          f"{len(kernels)} kernel names, the front's tile_kernel and the detect.frame span "
          f"among them; {device_ms:.2f} ms of device time)", flush=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"(x) phase took {time.perf_counter() - t0:.1f} s", flush=True)


NATIVE_DIR = os.path.join(HERE, "_native_smoke")  # gitignored, removed at the end of (y)


def native_phase(host_build_s: float, dets: dict, frames, sf, smi):
    """(y): the host library against its numpy plain versions; see the
    module docstring. dets: frontal-face detectors by plan label."""
    import shutil

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.data import native
    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.data.vec import read_vec, write_vec
    from cascadeclassifier_tpu_torch.detect.detector import _stack_rects
    from cascadeclassifier_tpu_torch.detect.grouping import DENSE_MAX, NATIVE_MAX, group_numpy
    from cascadeclassifier_tpu_torch.utils import time_grouping
    from cascadeclassifier_tpu_torch.utils.train_data import background, write_pgm, write_png

    t0 = time.perf_counter()
    # -- check 1: the build
    gxx = subprocess.run(["g++", "--version"], stdout=subprocess.PIPE, text=True,
                         check=True).stdout.splitlines()[0]
    lib_path = native.get_lib()._name
    check(os.path.dirname(os.path.dirname(lib_path)) == _build.BUILD_DIR,
          f"(y) check 1: the host library loaded from {lib_path}")
    print(f"(y) check 1: {gxx}; {_build.HOST_SOURCE} built in {host_build_s:.2f} s with "
          f"{' '.join(_build.GXX_FLAGS)} -> {os.path.relpath(lib_path, HERE)}", flush=True)

    # -- check 2: grouping, rects and order
    sizes = (64, 256, 1024, 2048, 4096, 8192)
    for n in sizes:
        rects = time_grouping.detection_like(n)
        for thr in (1, 3):
            got = native.group_rectangles_native(rects, thr)
            check(np.array_equal(got, group_numpy(rects, thr)),
                  f"(y) check 2: native grouping != numpy at {n} rects, threshold {thr}")
    raw = {}
    for label, d in dets.items():
        for k in range(4):
            plan, idx = d.raw_windows(frames[k], sf)
            rects = _stack_rects(plan, idx)
            raw.setdefault(label, []).append(len(rects))
            for thr in (1, 3):
                got = native.group_rectangles_native(rects, thr)
                check(np.array_equal(got, group_numpy(rects, thr)),
                      f"(y) check 2: native grouping != numpy on the frontal face's frame {k} "
                      f"({label}), threshold {thr}")
    print(f"(y) check 2: native grouping equals the numpy grouping (rects and order, "
          f"tolerance: exact) on detection-like sets of {', '.join(map(str, sizes))} rects at "
          f"thresholds 1 and 3, and on the frontal face's raw rects of frames 0-3 "
          f"{raw} at 1 and 3", flush=True)
    print(f"(y) check 2: grouping ms by size on the host of {smi} (CPU {host_cpu()}), "
          f"threshold 3, NATIVE_MAX {NATIVE_MAX}, DENSE_MAX {DENSE_MAX}:", flush=True)
    rows = time_grouping.measure((64, 128, 256, 512, 1024, 2048, 3072, 4096, 8192, 16384),
                                 3, 5, 4096)
    check(all(r["same"] for r in rows), "(y) check 2: the timed groupings disagree")
    print("(y) grouping table " + json.dumps({"native_max": NATIVE_MAX, "rows": rows}),
          flush=True)
    for (phase, engine), (table_ms, lib_ms, numpy_ms) in GROUP_MS.items():
        print(f"(y) check 2: ({phase}) engine {engine}: group {table_ms:.2f} ms/frame in the "
              f"phase table; on the same raw windows again, {lib_ms:.2f} through "
              f"group_rectangles against {numpy_ms:.2f} through the numpy grouping "
              f"(group_numpy), the same rects", flush=True)

    # -- check 3: the .vec codec and the miner
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    os.makedirs(NATIVE_DIR)
    rng = np.random.default_rng(0)
    samples = rng.integers(0, 256, (1000, 24, 24)).astype(np.uint8)
    p_nat, p_py = os.path.join(NATIVE_DIR, "native.vec"), os.path.join(NATIVE_DIR, "py.vec")
    check(native.native_write_vec(p_nat, samples), "(y) check 3: native_write_vec failed")
    write_vec(p_py, samples)
    with open(p_nat, "rb") as f, open(p_py, "rb") as g:
        check(f.read() == g.read(), "(y) check 3: the native .vec bytes != data/vec.py's")
    check(np.array_equal(read_vec(p_nat, 24, 24), samples)
          and np.array_equal(native.native_read_vec(p_py).reshape(-1, 24, 24), samples),
          "(y) check 3: a .vec round trip lost samples")
    check(native.native_read_vec(os.path.join(NATIVE_DIR, "missing.vec")) is None,
          "(y) check 3: a missing .vec read")
    names = []
    for i, (h, w) in enumerate(((120, 160), (97, 131), (150, 90), (200, 170), (20, 30),
                                (None, None), (64, 300))):
        path = os.path.join(NATIVE_DIR, f"bg{i}.{'pgm' if i % 2 == 0 else 'png'}")
        if h is not None:  # else: listed, never written
            img = (background(h, w, seed=i) if h > 40 else
                   rng.integers(0, 256, (h, w)).astype(np.uint8))
            (write_pgm if path.endswith(".pgm") else write_png)(path, img)
        names.append(path)
    bg = os.path.join(NATIVE_DIR, "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    for ww, wh in ((24, 24), (20, 12)):
        tp = time.perf_counter()
        want = NegReader(bg, ww, wh, lazy=False).take_batch(2000)
        tp = time.perf_counter() - tp
        tn = time.perf_counter()
        reader = native.NativeNegReader(bg, ww, wh)
        got = reader.take_batch(2000)
        reader.close()
        tn = time.perf_counter() - tn
        check(len(want) == 2000 and np.array_equal(got, want),
              f"(y) check 3: NativeNegReader != NegReader at {ww}x{wh}")
        print(f"(y) check 3: 2000 windows of {ww}x{wh} from {len(names)} listed backgrounds "
              f"(PGM and PNG, one of 20x30, one missing): NativeNegReader equals "
              f"NegReader(lazy=False) byte for byte; {tn * 1e3:.1f} ms against "
              f"{tp * 1e3:.1f} ms", flush=True)
    print("(y) check 3: native_write_vec writes data/vec.py's bytes for 1000 samples of "
          "24x24, and each reader reads the other's file", flush=True)
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    print(f"(y) phase took {time.perf_counter() - t0:.1f} s", flush=True)


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (lscpu's "Model name"), with
    its vendor, family and model numbers (the name may read "unknown")."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return (f"{info.get('model name', 'unknown')}: {info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{os.cpu_count()} CPUs")


def prep_phase(dev, model, timed, work, errs, launches):
    """(n) the prep kernel at the benchmark's shape: a 4K frame on the
    shelf-packed plan with f64 stage sums (the detector's defaults), against
    its twin bit for bit, one launch a frame, and its work for the table."""
    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, build_pixel_canvas
    from cascadeclassifier_tpu_torch.detect.integral import integral
    from cascadeclassifier_tpu_torch.detect.prep import prep
    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    w, h, sf = 3840, 2160, 1.1
    det = TorchDetector(model, device=dev)
    check(det.exact and det.pack_band and det.engine_name == "fused",
          "(n) prep: the frontal face's defaults are not exact, fused, shelf-packed")
    cas, plan = det.packed, det.plan_for(w, h, sf, None, None)
    img = synth_frame(0, h, w)
    levels, code = det.engine._plan_tensors(plan)
    s4, q4 = integral(build_pixel_canvas(torch.from_numpy(img).to(dev), plan, levels,
                                         torch.uint8))
    got = prep(s4, q4, code, cas, exact=True)
    t0 = time.perf_counter()
    want = prep(s4, q4, code, cas, impl="ref", exact=True)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    inv_bits = (got[0].view(torch.int32) != want[0].view(torch.int32)).sum()
    errs["prep"] = int(inv_bits) + int((got[1] != want[1]).sum())
    check(errs["prep"] == 0, f"(n) prep kernel != twin at 4K: {errs['prep']} windows differ")
    _build.LAUNCHES.clear()
    det.raw_windows(img, sf)
    torch.cuda.synchronize()
    launches["prep"] = _build.LAUNCHES["prep"]
    check(launches["prep"] == 1, f"(n) a 4K frame made {launches['prep']} prep launches")
    n_win = plan.out_h * plan.out_w
    print(f"(n) prep: 4K shelf-packed canvas {plan.canvas_h} x {plan.canvas_w}, {n_win} "
          f"windows, {int(((code & 1) != 0).sum())} on the grid, "
          f"{int(((code & 2) != 0).sum())} reset columns, "
          f"{int(got[1].sum())} alive; inv_nf bit for bit and alive equal to the twin "
          f"(tolerance: exact); one launch a frame; the twin's one call {twin_ms:.1f} ms",
          flush=True)
    timed["prep"] = (lambda: prep(s4, q4, code, cas, exact=True), twin_ms, None, 1)
    # sum and sq read once, the code byte read and inv_nf and alive written
    # once a window; the gate (14 operations) and stage 0 at every window
    work["prep"] = bound(2 * 4 * s4.numel() + (1 + 4 + 1) * n_win,
                         n_win * (14 + stage_ops(cas.stages[0])))


def kernel_vs_twin(name: str, run, ctx):
    """run(impl=...) through the kernel and its twin on the card, equal
    bit for bit → the kernel's output; records the max abs error, and the
    kernel and twin calls for the timing table."""
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = run(impl="ref")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3  # the twin's one call, timed here
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    ctx["errs"][name] = max(ctx["max_abs_err"](g, w) for g, w in pairs)
    check(all(torch.equal(g, w) for g, w in pairs), f"kernel {name} != its twin")
    ctx["timed"][name] = (run, plain_ms, None, 1)
    return got


def e2e(det, frames, sf, ks, kernels):
    """Raw windows of frames ks through det with the launches counted from
    0 → (counts, {k: windows}); each of kernels was launched."""
    from cascadeclassifier_tpu_torch import _build

    _build.LAUNCHES.clear()
    got = {k: det.raw_windows(frames[k], sf)[1] for k in ks}
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for name in kernels:
        check(counts.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    return counts, got


def check_golden(label: str, plan, got, golden):
    """The golden's frames, grouped at minNeighbors 3 and 0, equal its rects."""
    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector

    for g in golden["frames"]:
        for mn in (3, 0):
            ours = sorted(map(list, TorchDetector.group(plan, got[g["k"]], mn).tolist()))
            check(ours == g[f"rects_mn{mn}"],
                  f"{label} frame {g['k']} minNeighbors {mn}: {len(ours)} rects vs "
                  f"{len(g[f'rects_mn{mn}'])} in the OpenCV golden")


def cascade_phase(tag: str, xml: str, golden_path: str, img0, ctx) -> list:
    """(q) / (r): a node-tree or LBP cascade at 1080p, every stage in the
    tile kernel → [(label, detector)] to profile."""
    from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, build_pixel_canvas
    from cascadeclassifier_tpu_torch.detect.front import front
    from cascadeclassifier_tpu_torch.detect.integral import integral
    from cascadeclassifier_tpu_torch.detect.stage import stage
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml

    t0 = time.perf_counter()
    dev, frames, sf = ctx["dev"], ctx["frames"], ctx["sf"]
    with open(golden_path) as f:
        golden = json.load(f)
    for g in golden["frames"]:
        check(hashlib.sha256(frames[g["k"]].tobytes()).hexdigest() == g["sha256"],
              f"({tag}) synth frame {g['k']} differs from the golden's")
    model = read_cascade_xml(xml)
    det_a = TorchDetector(model, device=dev)
    c = det_a.packed
    check(det_a.exact and det_a.engine_name == "pallas",
          f"({tag}) {c.kind} cascade routed to {det_a.engine_name}")
    n = len(c.stages)
    pol = c.kind
    # the stage kernel on the stage engine's canvas, every stage
    plan_a = det_a.plan_for(1920, 1080, sf, None, None)
    levels_a, grid_a = det_a.engine._walk_tensors(plan_a)[:2]
    s_a, q_a = integral(build_pixel_canvas(img0, plan_a, levels_a))
    inv_a, alive_a = None, grid_a
    if not c.is_lbp:
        gate_a, inv_a = dense_variance_gate(s_a, q_a, c.win_w, c.win_h, plan_a.out_h,
                                            plan_a.out_w)
        alive_a = gate_a & grid_a
    for exact in (False, True):
        name = f"stage ({pol})" if exact else f"stage ({pol}, f32)"
        a_k, p_k = kernel_vs_twin(name, lambda exact=exact, **kw: stage(
            s_a, s_a, inv_a, alive_a, c, 0, n, exact=exact, **kw), ctx)
        print(f"({tag}) stage ({pol} policy, {'f64' if exact else 'f32'}): stages 0-{n - 1}, "
              f"{int(alive_a.sum())} windows in, {int(p_k.sum())} pass stage 0, "
              f"{int(a_k.sum())} all; alive and passed0 equal to the twin (tolerance: exact)",
              flush=True)
    del ctx["timed"][f"stage ({pol}, f32)"]
    # the front kernel on the fused engine's prep mask (shelf-packed plan)
    det_f = TorchDetector(model, device=dev, engine="fused")
    plan_f = det_f.plan_for(1920, 1080, sf, None, None)
    px_f = build_pixel_canvas(img0, plan_f, det_f.engine._plan_tensors(plan_f)[0], torch.uint8)
    s_f, q_f = integral(px_f)
    check(det_f.engine.n_dense == n, f"({tag}) the fused engine left stages to a tail")
    for exact in (False, True):
        d_e = det_f if exact else TorchDetector(model, exact=False, device=dev, engine="fused")
        inv_f, alive_f = d_e.engine.prep(s_f, q_f, plan_f)
        name = f"front ({pol})" if exact else f"front ({pol}, f32)"
        f_k = kernel_vs_twin(name, lambda exact=exact, inv_f=inv_f, alive_f=alive_f, **kw: front(
            s_f, inv_f, alive_f, c, 1, n, exact=exact, **kw), ctx)
        print(f"({tag}) front ({pol} policy, {'f64' if exact else 'f32'}): stages 1-{n - 1} on "
              f"the shelf-packed canvas, {int(alive_f.sum())} windows after prep, "
              f"{int(f_k.sum())} after; equal to the twin (tolerance: exact)", flush=True)
    del ctx["timed"][f"front ({pol}, f32)"]
    # end to end: both engines, both modes, against the OpenCV golden
    for engine in ("pallas", "fused"):
        for exact in (True, False):
            d = {("pallas", True): det_a, ("fused", True): det_f}.get((engine, exact)) or \
                TorchDetector(model, exact=exact, device=dev, engine=engine)
            kern = "stage" if engine == "pallas" else "front"
            counts, got = e2e(d, frames, sf, (0, 1), (kern,))
            check("patchify" not in counts and "packed_front" not in counts,
                  f"({tag}) {engine}: a tail or the packed front ran")
            check_golden(f"({tag}) {engine}, exact={exact}", d.plan_for(1920, 1080, sf, None,
                                                                         None), got, golden)
            if exact:
                ctx["launches"][f"{kern} ({pol})"] = (counts[kern], len(got))
            print(f"({tag}) e2e {os.path.basename(xml)}, engine {engine}"
                  f"{' (auto)' if engine == 'pallas' else ''}, exact={exact}: frames 0,1 raw "
                  f"windows {[len(x) for x in got.values()]}, equal to the OpenCV golden at "
                  f"minNeighbors 3 and 0 ({[len(g['rects_mn3']) for g in golden['frames']]} and "
                  f"{[len(g['rects_mn0']) for g in golden['frames']]} rects); launches {counts}",
                  flush=True)
    for d in (det_a, det_f):
        detection_timing(f"{tag}, {os.path.basename(xml)}", d, frames, sf, ctx["smi"])
    # bounds: the nodes each window visits, f64 sums at the f32 rate
    n_win = plan_a.out_h * plan_a.out_w
    ev_a = {0: torch.arange(n_win, device=dev)}
    ev_a.update({si: flat_alive(stage(s_a, s_a, inv_a, alive_a, c, 0, si, exact=True)[0])
                 for si in range(1, n)})
    per_win = 3 if c.is_lbp else 7  # inv_nf (Haar), the masks in and out, passed0
    ctx["work"][f"stage ({pol})"] = bound(4 * s_a.numel() + per_win * n_win,
                                          walk_ops(c, s_a, s_a, inv_a, plan_a.out_w, ev_a))
    inv_f, alive_f = det_f.engine.prep(s_f, q_f, plan_f)
    ev_f = {1: flat_alive(alive_f)}
    ev_f.update({si: flat_alive(front(s_f, inv_f, alive_f, c, 1, si, exact=True))
                 for si in range(2, n)})
    n_win_f = plan_f.out_h * plan_f.out_w
    ctx["work"][f"front ({pol})"] = bound(4 * s_f.numel() + (2 if c.is_lbp else 6) * n_win_f,
                                          walk_ops(c, s_f, s_f, inv_f, plan_f.out_w, ev_f))
    print(f"({tag}) phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return [(f"{os.path.basename(xml)}, auto (pallas)", det_a),
            (f"{os.path.basename(xml)}, fused", det_f)]


# (phase, engine) -> "group" ms a frame: the phase table's, then on the
# same raw windows through group_rectangles and through group_numpy (the
# grouping before the host library), timed side by side; by detection_timing
GROUP_MS = {}


def detection_timing(phase: str, det, frames, sf, smi):
    """frames/s over the frames after one warm-up frame, then the phase
    table (device synchronized after each phase) over the same frames."""
    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector

    det.detect_multi_scale_batch(frames[:1], sf, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.detect_multi_scale_batch(frames, sf, 3)
    torch.cuda.synchronize()
    fps = len(frames) / (time.perf_counter() - t0)
    print(f"({phase}) timing: {fps:.2f} frames/s at 1080p over {len(frames)} frames "
          f"(engine {det.engine_name}, {'shelf-packed' if det.pack_band else 'plain-stack'} "
          f"plan, sf {sf}, minNeighbors 3) on {smi}", flush=True)
    phases = {}
    raw = []
    t0 = time.perf_counter()
    for f in frames:
        plan_f, idx_f = det.raw_windows(f, sf, timings=phases)
        tg = time.perf_counter()
        TorchDetector.group(plan_f, idx_f, 3)
        phases["group"] = phases.get("group", 0.0) + (time.perf_counter() - tg) * 1e3
        raw.append((plan_f, idx_f))
    total = (time.perf_counter() - t0) * 1e3
    phases["other"] = total - sum(phases.values())
    GROUP_MS[(phase, det.engine_name)] = (phases["group"] / len(frames),
                                          *group_both_ms(raw, 3))
    print(f"({phase}) ms/frame by phase (device synchronized after each): " + ", ".join(
        f"{k} {v / len(frames):.2f}" for k, v in phases.items()
    ) + f"; total {total / len(frames):.2f}", flush=True)


def group_both_ms(raw, min_neighbors: int):
    """TorchDetector.group's step on each (plan, raw window indices)
    through group_rectangles (the host library up to NATIVE_MAX rects)
    and through group_numpy, alternating, with the same rects from both →
    (ms a frame, ms a frame)."""
    from cascadeclassifier_tpu_torch.detect.detector import _stack_rects
    from cascadeclassifier_tpu_torch.detect.grouping import (
        clip_rects,
        group_numpy,
        group_rectangles,
    )

    ms = [0.0, 0.0]
    for plan, idx in raw:
        got = []
        for k, group in enumerate((group_rectangles, group_numpy)):
            t = time.perf_counter()
            got.append(clip_rects(group(_stack_rects(plan, idx), min_neighbors), plan.img_w,
                                  plan.img_h))
            ms[k] += (time.perf_counter() - t) * 1e3
        check(np.array_equal(*got), "group_rectangles != group_numpy on a frame's raw windows")
    return ms[0] / len(raw), ms[1] / len(raw)


def profile(name: str, det, frames, sf):
    """torch.profiler over detect_multi_scale on the frames (after one
    untraced warm-up frame): device kernel time, wall time traced and
    untraced, kernel launches and stream synchronizations per frame."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    det.detect_multi_scale_batch(frames[:1], sf, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.detect_multi_scale_batch(frames, sf, 3)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.detect_multi_scale_batch(frames, sf, 3)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.device_time for e in events) / 1e3
    # cudaLaunchKernelExC too: the integral's programmatic dependent launches
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(1 for e in prof.events() if "Synchronize" in e.name)
    n = len(frames)
    print(f"profile {name}: device kernel time {kernel_ms / n:.2f} ms/frame, wall "
          f"{wall / n:.2f} ms/frame untraced ({traced / n:.2f} traced), device idle "
          f"{100 * (1 - kernel_ms / wall):.1f} % of the untraced wall; "
          f"{launches / n:.0f} kernel launches and {syncs / n:.0f} synchronizations "
          f"a frame", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8), flush=True)
    return syncs / n


if __name__ == "__main__":
    main()
