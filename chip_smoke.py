"""Smoke run of the PyTorch/CUDA port on one GPU at 1080p.

    python3 chip_smoke.py

Drives cascadeclassifier_tpu_torch's detection paths through
TorchDetector on cuda:0, on 1920x1080 synthetic frames at scaleFactor
1.1, and checks them. The frontal-face path (haarcascade_frontalface_alt
.xml, 22 upright stages, engine "fused") on the plain vertical stack
(pack_band=False):

  (a) build     compile the six CUDA kernels from csrc/, one nvcc per
                source, all started together (seconds)
  (b) integral  kernel integral vs its plain twin on frame 0's canvas
  (c) front     kernel front vs its twin over stages 1..n_dense-1, on the
                ystep-2 and ystep-1 rows separately; survivors > 0
  (d) patchify  kernel patchify vs its twin on the front's survivors, at
                a capacity equal to and larger than the live count
  (e) e2e       frames 0-3 through the kernels equal the twin path on
                the card; frames 0 and 1 equal the committed OpenCV
                golden at minNeighbors 3 and 0; every kernel launched
  (f) timing    frames/s over 8 frames after a warm-up, phase table

The upper-body path (haarcascade_upperbody.xml, 30 stages with tilted
features, engine "pallas"):

  (g) tilted    kernel tilted vs its twin on frame 0's canvas
  (h) stage     kernel stage vs its twin over stages 0-29 (alive and
                stage 0's pass mask), and over the chunk 1-29
  (i) e2e       frames 0 and 1 through the kernels equal the twin path
                and the committed OpenCV golden at minNeighbors 3 and 0;
                tilted and stage launched
  (j) timing    frames/s over 8 frames after a warm-up, phase table

The frontal face again on the shelf-packed plan (pack_band=True, the
fused engine's default), with the dense front and with the packed front
(packed_front=True):

  (k) plan      both canvases; kernel integral vs its twin on the
                shelf-packed canvas
  (l) packed    the live-block list vs the list built on the CPU; kernel
                packed_front vs its twin and vs kernel front over stages
                1..n_dense-1 on frame 0's prep mask; survivors and the
                live-block fraction
  (m) e2e       per front: frames 0-3 equal the twin path and map to the
                plain stack's rects, frames 0 and 1 equal the OpenCV
                golden at minNeighbors 3 and 0, and packed_front (or
                front) alone was launched
  (n) timing    per front: frames/s and phase table; both front kernels
                and the list build timed on the shelf-packed canvas

The tiled front and stage kernels at their edges:

  (o) edges     kernels front and stage vs their twins on small canvases
                whose window grid is one less than, equal to and one more
                than two tiles each way, with every tile dead, every
                window alive, one window alive in the last row and column
                and a checkerboard: front over stages [1, 8), [3, 5) and
                [4, 4); stage over [0, 30), [0, 1), [1, 30) and [5, 9) of
                the upper body and over [0, 22) of the frontal face with
                the integral canvas passed as the tilted one. Each kernel
                twice on frame 0's 1080p inputs with equal outputs, and
                the front's stages through the stage kernel (the same
                tile kernel with its dense pass compiled in), timed

and last, per kernel at its path's shapes: time against its twin, the
least time the card could take (bytes over 3.35 TB/s or operations over
67 TFLOP/s, the H100 SXM's published rates), and one PyTorch call that
computes the same function where one exists; then each path traced with
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

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: float, nops: float):
    """(least ms, what bounds it): each input read and each output written
    once over the memory rate, or the operations over the f32 rate."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
    from cascadeclassifier_tpu_torch.detect.detector import (
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
    from cascadeclassifier_tpu_torch.detect.tilted import segments, tilted
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
    from cascadeclassifier_tpu_torch.utils.edges import (
        FRONT_RANGES,
        STAGE_RANGES,
        edge_mismatches,
    )
    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    dev = torch.device("cuda:0")
    data = os.path.join(HERE, "cascadeclassifier_tpu_torch", "data")
    model = read_cascade_xml(os.path.join(data, "haarcascade_frontalface_alt.xml"))
    with open(os.path.join(data, "smoke_golden_1080p.json")) as f:
        golden = json.load(f)
    H, W, SF = golden["height"], golden["width"], golden["scale_factor"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # (a) build
    t0 = time.perf_counter()
    _build.lib()
    print(f"(a) build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)} -> sm_90a)", flush=True)

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

    # (b) integral
    px = build_pixel_canvas(img0, plan, levels)
    s_k, q_k = integral(px)
    s_r, q_r = integral(px, impl="ref")
    torch.cuda.synchronize()
    errs["integral"] = max(max_abs_err(s_k, s_r), max_abs_err(q_k, q_r))
    check(torch.equal(s_k, s_r) and torch.equal(q_k, q_r), "integral kernel != twin")
    print(f"(b) integral: canvas {tuple(px.shape)} sum and sq equal to the twin "
          f"(tolerance: exact, max_abs_err {errs['integral']})", flush=True)

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
    for name in ("integral", "front", "patchify"):
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
    timed["front"] = (lambda: front(s_k, inv_nf, alive0, cas, 1, eng.n_dense),
                      lambda: front(s_k, inv_nf, alive0, cas, 1, eng.n_dense, impl="ref"),
                      None, 3)
    timed["patchify"] = (lambda: patchify(s_k, r, c, ncells, cas.win_w, cas.win_h),
                         lambda: patchify(s_k, r, c, ncells, cas.win_w, cas.win_h, impl="ref"),
                         lambda: s_k.reshape(-1)[flat], 3)
    work["integral"] = bound(3 * 4 * hw, 5 * hw)
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
    levels_b, grid_b = eng_b._plan_tensors(plan_b)[:2]
    pad = int(plan_b.scaled_h.max()) + 1

    # (g) tilted
    px_b = build_pixel_canvas(img0, plan_b, levels_b)
    t_k = tilted(px_b, plan_b.is_top, pad)
    t_r = tilted(px_b, plan_b.is_top, pad, impl="ref")
    torch.cuda.synchronize()
    errs["tilted"] = max_abs_err(t_k, t_r)
    check(torch.equal(t_k, t_r), "tilted kernel != twin")
    print(f"(g) tilted: canvas {tuple(px_b.shape)}, {len(plan_b.scales)} blocks, equal to the "
          f"twin (tolerance: exact, max_abs_err {errs['tilted']})", flush=True)

    # (h) stage
    sb, qb = integral(px_b)
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
    seg = segments(plan_b.is_top, pad)
    # per padded cell: two neighbours, T[y-2] and two pixels
    tilted_cells = int(((seg[:, 1] - seg[:, 0]) * (px_b.shape[1] + 2 * seg[:, 2])).sum())
    work["tilted"] = bound(2 * 4 * px_b.numel(), 5 * tilted_cells)
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
    px_p = build_pixel_canvas(img0, plan_p, det_p.engine._plan_tensors(plan_p)[0])
    sp_k, qp_k = integral(px_p)
    sp_r, qp_r = integral(px_p, impl="ref")
    torch.cuda.synchronize()
    err = max(max_abs_err(sp_k, sp_r), max_abs_err(qp_k, qp_r))
    errs["integral"] = max(errs["integral"], err)
    check(torch.equal(sp_k, sp_r) and torch.equal(qp_k, qp_r),
          "integral kernel != twin on the shelf-packed canvas")
    print(f"(k) plan: shelf-packed canvas {plan_p.canvas_h} x {plan_p.canvas_w} "
          f"({px_p.numel()} cells) against the plain stack's {plan.canvas_h} x "
          f"{plan.canvas_w} ({px.numel()} cells); integral equal to the twin there "
          f"(tolerance: exact, max_abs_err {err})", flush=True)

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
          f"kernel {packed_ms:.4f} ms, live-block list {blk_ms:.4f} ms", flush=True)
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
    again = front(s_k, inv_nf, alive0, cas, 1, n_dense)
    check(torch.equal(again, f_k), "(o) front kernel: two runs on the same inputs differ")
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

    meta = {
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
    kernels = []
    for name, (fk, fr, flib, plain_reps) in timed.items():
        ms = cuda_ms(fk, 20)
        plain_ms = cuda_ms(fr, plain_reps)
        library_ms = cuda_ms(flib, 20) if flib is not None else None
        bound_ms, bound_by = work[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
        print(f"kernel {name}: {ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}", flush=True)
    syncs = {}
    for name, d in (("frontal face", det), ("upper body", det_b),
                    ("frontal face shelf-packed", shelf[False]),
                    ("frontal face shelf-packed, packed front", shelf[True])):
        syncs[name] = profile(name, d, frames[:4], SF)
    check(syncs["frontal face shelf-packed, packed front"] <= syncs["frontal face shelf-packed"],
          "the packed front adds host synchronizations")
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


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
    t0 = time.perf_counter()
    for f in frames:
        plan_f, idx_f = det.raw_windows(f, sf, timings=phases)
        tg = time.perf_counter()
        TorchDetector.group(plan_f, idx_f, 3)
        phases["group"] = phases.get("group", 0.0) + (time.perf_counter() - tg) * 1e3
    total = (time.perf_counter() - t0) * 1e3
    phases["other"] = total - sum(phases.values())
    print(f"({phase}) ms/frame by phase (device synchronized after each): " + ", ".join(
        f"{k} {v / len(frames):.2f}" for k, v in phases.items()
    ) + f"; total {total / len(frames):.2f}", flush=True)


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
    device_ms = sum(e.device_time for e in events) / 1e3
    launches = sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel"))
    syncs = sum(1 for e in prof.events() if "Synchronize" in e.name)
    n = len(frames)
    print(f"profile {name}: device kernel time {device_ms / n:.2f} ms/frame, wall "
          f"{wall / n:.2f} ms/frame untraced ({traced / n:.2f} traced), device idle "
          f"{100 * (1 - device_ms / wall):.1f} % of the untraced wall; "
          f"{launches / n:.0f} kernel launches and {syncs / n:.0f} synchronizations "
          f"a frame", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8), flush=True)
    return syncs / n


if __name__ == "__main__":
    main()
