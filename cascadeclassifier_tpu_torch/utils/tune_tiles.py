"""Times the tiled front, packed front and stage kernels under other tile
geometries, the tilted kernel under other chunk and strip sizes, and the
integral kernel under other bands and apply-pass layouts.

    python3 -m cascadeclassifier_tpu_torch.utils.tune_tiles [--quick] [--integral]
        [-DNAME=VALUE ...]

Needs a CUDA device and nvcc. On 1080p synthetic frame 0 at scaleFactor
1.1 it builds the kernels once per geometry (tile rows and threads a
block, the macros CCT_FRONT_TILE_H, CCT_FRONT_THREADS, CCT_STAGE_TILE_H,
CCT_STAGE_THREADS and CCT_PACKED_THREADS of ``csrc/front.cu``,
``csrc/stage.cu`` and ``csrc/packed_front.cu``; rows a chunk and columns a
strip, CCT_TILTED_CHUNK and CCT_TILTED_STRIP of ``csrc/tilted.cu``) and
prints, per geometry, the device time of

  front        stages 1..n_dense-1 of the frontal face on its prep mask
  stage        all 30 stages of the upper body on gate AND grid
  stage 0      its dense pass alone (stages [0, 1))
  stage 1-29   its compacted passes alone, on the mask stage 0 leaves
  packed_front the front's stages over the live-block list of the
               shelf-packed canvas, beside front there and the list build
  tilted       the tilted integral of the upper body's canvas, and of its
               first pyramid level alone
  integral     rows a band, threads of the apply pass, adjacent columns a
               thread and columns a block of the carry scan
               (CCT_INTEGRAL_ROWS, CCT_INTEGRAL_THREADS, CCT_INTEGRAL_COLS,
               CCT_INTEGRAL_STRIP of ``csrc/integral.cu``): the frontal
               plain-stack canvas as uint8, as int32 and shelf-packed, the
               upper body's int32 canvas, and the three launches apart on
               the plain-stack canvas as uint8 and as int32 (device time
               by kernel name, torch.profiler); first, as yardsticks, the
               write of both outputs by fill_ and the integral on
               the plain-stack canvas one column narrower (output rows
               128-byte aligned) and 2 048 columns wide

after checking each output against the default geometry's (the integral's
against its twin). Further -D flags on the command line are passed to
every build; --quick times the default geometry alone; --integral times
the integral alone. The geometry the sources default to is the first
line; ``detect/records.py::TILE_H`` must name the stage kernel's tile
rows, ``detect/tilted.py::CHUNK_ROWS`` and ``STRIP_COLS`` the tilted
kernel's chunk and strip, ``detect/integral.py::BAND_ROWS`` the integral
kernel's band.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect import integral as integral_mod
from cascadeclassifier_tpu_torch.detect import records
from cascadeclassifier_tpu_torch.detect import tilted as tilted_mod
from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, build_pixel_canvas
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import integral
from cascadeclassifier_tpu_torch.detect.packed_front import live_block_list, packed_front
from cascadeclassifier_tpu_torch.detect.stage import stage
from cascadeclassifier_tpu_torch.detect.tilted import tilted
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
from cascadeclassifier_tpu_torch.utils.synth import synth_frame

FRONT_GEOMETRIES = ((16, 256), (16, 128), (16, 512), (8, 128), (8, 256), (4, 128), (32, 256),
                    (32, 512))
STAGE_GEOMETRIES = ((16, 256), (16, 512), (16, 128), (8, 128), (8, 256), (8, 512), (32, 512),
                    (32, 1024))
PACKED_THREADS = (256, 128, 512)
TILTED_GEOMETRIES = ((64, 256), (64, 128), (64, 384), (64, 512), (32, 192), (32, 448),
                     (96, 320), (128, 256), (16, 224))  # (rows a chunk, columns a strip)
# (rows a band, threads of the apply pass, adjacent columns a thread,
# columns a block of the carry scan)
INTEGRAL_GEOMETRIES = ((32, 256, 8, 32), (32, 256, 8, 16), (32, 256, 8, 8), (24, 256, 8, 32),
                       (40, 256, 8, 32), (48, 256, 8, 32), (16, 256, 8, 16), (64, 256, 8, 32),
                       (32, 128, 16, 32), (32, 512, 4, 32))
INTEGRAL_LAUNCHES = ("band_sums", "band_carry", "band_apply")


def cuda_ms(fn, reps: int = 10) -> float:
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


def launch_ms(fn, names, reps: int = 20) -> dict:
    """Device ms a call of fn() spent in each kernel whose name holds one
    of names, from torch.profiler over reps calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        for name in names:
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
                out[name] += e.device_time / 1e3 / reps
    return out


def tune_integral(extra, quick: bool, canvases: dict):
    """Times every integral geometry on canvases (label → px), each output
    held against the twin first; the launches apart on the first two."""
    want = {label: integral(px, impl="ref") for label, px in canvases.items()}
    first = next(iter(canvases))
    outs = torch.empty((2, *canvases[first].shape), dtype=torch.int32,
                       device=canvases[first].device)
    narrow = canvases[first][:, :-1].contiguous()
    wide = torch.zeros((narrow.shape[0], 2048), dtype=narrow.dtype, device=narrow.device)
    print(f"{first}: both outputs written by fill_ (8 bytes a cell, the write floor) "
          f"{cuda_ms(lambda: outs.fill_(1), 20):.4f} ms; integral on its first "
          f"{narrow.shape[1]} columns (output rows 128-byte aligned) "
          f"{cuda_ms(lambda: integral(narrow), 20):.4f} ms, on 2048 columns "
          f"{cuda_ms(lambda: integral(wide), 20):.4f} ms", flush=True)
    for rows, nt, cols, strip in INTEGRAL_GEOMETRIES[: 1 if quick else None]:
        _build.NVCC_FLAGS = BASE_FLAGS + (f"-DCCT_INTEGRAL_ROWS={rows}",
                                          f"-DCCT_INTEGRAL_THREADS={nt}",
                                          f"-DCCT_INTEGRAL_COLS={cols}",
                                          f"-DCCT_INTEGRAL_STRIP={strip}", *extra)
        _build._lib = None
        integral_mod.BAND_ROWS = rows
        _build.lib()
        same = all(torch.equal(g, r) for label, px in canvases.items()
                   for g, r in zip(integral(px), want[label]))
        times = ", ".join(f"{label} {cuda_ms(lambda: integral(px), 20):.4f}"
                          for label, px in canvases.items())
        apart = "; ".join(
            f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in launch_ms(
                lambda: integral(canvases[label]), INTEGRAL_LAUNCHES).items())
            for label in list(canvases)[:2])
        print(f"integral {rows:3d} rows a band, {nt:4d} threads x {cols:2d} columns, carry "
              f"strips of {strip:2d}: "
              f"{times} ms; {apart}{'' if same else '  OUTPUT DIFFERS'}", flush=True)
    _build.NVCC_FLAGS = BASE_FLAGS + tuple(extra)
    _build._lib = None
    integral_mod.BAND_ROWS = INTEGRAL_GEOMETRIES[0][0]


def rebuild(flags, cascades, stage_tile_h: int, tilted_geometry=TILTED_GEOMETRIES[0]):
    """Point the package at a build with these extra nvcc flags."""
    _build.NVCC_FLAGS = BASE_FLAGS + tuple(flags)
    _build._lib = None
    integral_mod.BAND_ROWS = INTEGRAL_GEOMETRIES[0][0]
    records.TILE_H = stage_tile_h
    tilted_mod.CHUNK_ROWS, tilted_mod.STRIP_COLS = tilted_geometry
    tilted_mod._device_work.cache_clear()
    for cas in cascades:
        cas._tables.clear()
    _build.lib()


def main(extra):
    quick, only_integral = "--quick" in extra, "--integral" in extra
    extra = [a for a in extra if a not in ("--quick", "--integral")]
    if not torch.cuda.is_available():
        raise SystemExit("tune_tiles needs a CUDA device")
    dev = torch.device("cuda:0")
    data = os.path.join(_build.PKG_DIR, "data")
    img = torch.from_numpy(synth_frame(0, 1080, 1920)).to(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "extra flags:", extra)

    det = TorchDetector(read_cascade_xml(os.path.join(data, "haarcascade_frontalface_alt.xml")),
                        device=dev, pack_band=False)
    eng, cas = det.engine, det.packed
    plan = det.plan_for(1920, 1080, 1.1, None, None)
    px_f = build_pixel_canvas(img, plan, eng._plan_tensors(plan)[0], torch.uint8)
    sum_f, sq_f = integral(px_f)
    inv_f, alive_f = eng.prep(sum_f, sq_f, plan)

    det_b = TorchDetector(read_cascade_xml(os.path.join(data, "haarcascade_upperbody.xml")),
                          device=dev)
    cas_b = det_b.packed
    n_st = len(cas_b.stages)
    plan_b = det_b.plan_for(1920, 1080, 1.1, None, None)
    levels_b, grid_b = det_b.engine._walk_tensors(plan_b)[:2]
    px_b = build_pixel_canvas(img, plan_b, levels_b)
    sum_b, sq_b = integral(px_b)
    pad_b = int(plan_b.scaled_h.max()) + 1
    tilt_b = tilted(px_b, plan_b.is_top, pad_b)
    first_b = int(plan_b.block_top[1])  # the first pyramid level's rows alone
    px_b0, top_b0 = px_b[:first_b].contiguous(), plan_b.is_top[:first_b]
    gate_b, inv_b = dense_variance_gate(sum_b, sq_b, cas_b.win_w, cas_b.win_h,
                                        plan_b.out_h, plan_b.out_w)
    alive_b = gate_b & grid_b

    det_p = TorchDetector(det.model, device=dev)  # the shelf-packed plan
    plan_p = det_p.plan_for(1920, 1080, 1.1, None, None)
    px_p = build_pixel_canvas(img, plan_p, det_p.engine._plan_tensors(plan_p)[0], torch.uint8)
    sum_p, sq_p = integral(px_p)
    canvases = {"plain u8": px_f, "plain int32": px_f.int(), "shelf u8": px_p,
                "upper body int32": px_b}
    if only_integral:
        tune_integral(extra, quick, canvases)
        return
    inv_p, alive_p = det_p.engine.prep(sum_p, sq_p, plan_p)
    blk, nblk = live_block_list(alive_p)

    def run_front():
        return front(sum_f, inv_f, alive_f, cas, 1, eng.n_dense)

    def run_packed():
        return packed_front(sum_p, inv_p, alive_p, blk, nblk, cas, 1, eng.n_dense)

    def run_tilted():
        return tilted(px_b, plan_b.is_top, pad_b)

    def run_stage(s0=0, s1=n_st, alive=alive_b):
        return stage(sum_b, tilt_b, inv_b, alive, cas_b, s0, s1)

    rebuild(extra, (cas, cas_b), STAGE_GEOMETRIES[0][0])
    want_f = run_front()
    want_b = run_stage()
    after0 = alive_b & want_b[1]
    for s1 in (1, 2, 3, 5, 10, 20, n_st):
        print(f"stage, stages [1, {s1}) on the mask stage 0 leaves: "
              f"{cuda_ms(lambda: run_stage(1, s1, after0)):.4f} ms; "
              f"{int(run_stage(1, s1, after0)[0].sum())} windows left", flush=True)
    for th, nt in FRONT_GEOMETRIES[: 1 if quick else None]:
        rebuild([f"-DCCT_FRONT_TILE_H={th}", f"-DCCT_FRONT_THREADS={nt}", *extra], (cas, cas_b),
                STAGE_GEOMETRIES[0][0])
        same = torch.equal(run_front(), want_f)
        print(f"front {th:2d} x 128 windows, {nt:4d} threads: {cuda_ms(run_front):.4f} ms"
              f"{'' if same else '  OUTPUT DIFFERS'}", flush=True)
    for th, nt in STAGE_GEOMETRIES[: 1 if quick else None]:
        rebuild([f"-DCCT_STAGE_TILE_H={th}", f"-DCCT_STAGE_THREADS={nt}", *extra], (cas, cas_b),
                th)
        got = run_stage()
        same = torch.equal(got[0], want_b[0]) and torch.equal(got[1], want_b[1])
        print(f"stage {th:2d} x 128 windows, {nt:4d} threads: {cuda_ms(run_stage):.4f} ms, "
              f"stage 0 {cuda_ms(lambda: run_stage(0, 1)):.4f} ms, stages 1-{n_st - 1} "
              f"{cuda_ms(lambda: run_stage(1, n_st, after0)):.4f} ms"
              f"{'' if same else '  OUTPUT DIFFERS'}", flush=True)
    rebuild(extra, (cas, cas_b), STAGE_GEOMETRIES[0][0])
    want_p = front(sum_p, inv_p, alive_p, cas, 1, eng.n_dense)
    print(f"shelf-packed canvas: front "
          f"{cuda_ms(lambda: front(sum_p, inv_p, alive_p, cas, 1, eng.n_dense)):.4f} ms, "
          f"live-block list {cuda_ms(lambda: live_block_list(alive_p)):.4f} ms "
          f"({int(nblk[0])} of {blk.shape[0]} blocks)", flush=True)
    for nt in PACKED_THREADS[: 1 if quick else None]:
        rebuild([f"-DCCT_PACKED_THREADS={nt}", *extra], (cas, cas_b), STAGE_GEOMETRIES[0][0])
        same = torch.equal(run_packed(), want_p)
        print(f"packed_front 16 x 128 windows, {nt:4d} threads: {cuda_ms(run_packed):.4f} ms"
              f"{'' if same else '  OUTPUT DIFFERS'}", flush=True)
    for rows, cols in TILTED_GEOMETRIES[: 1 if quick else None]:
        rebuild([f"-DCCT_TILTED_CHUNK={rows}", f"-DCCT_TILTED_STRIP={cols}", *extra],
                (cas, cas_b), STAGE_GEOMETRIES[0][0], (rows, cols))
        same = torch.equal(run_tilted(), tilt_b)
        print(f"tilted {rows:3d} rows a chunk, {cols:3d} columns a strip "
              f"({cols + 2 * rows:4d} threads): {cuda_ms(run_tilted):.4f} ms, the first level "
              f"alone {cuda_ms(lambda: tilted(px_b0, top_b0, pad_b)):.4f} ms"
              f"{'' if same else '  OUTPUT DIFFERS'}", flush=True)
    rebuild(extra, (cas, cas_b), STAGE_GEOMETRIES[0][0])
    tune_integral(extra, quick, canvases)


BASE_FLAGS = _build.NVCC_FLAGS

if __name__ == "__main__":
    main(sys.argv[1:])
