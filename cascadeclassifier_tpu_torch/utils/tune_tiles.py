"""Times the tiled front and stage kernels under other tile geometries.

    python3 -m cascadeclassifier_tpu_torch.utils.tune_tiles [--quick] [-DNAME=VALUE ...]

Needs a CUDA device and nvcc. On 1080p synthetic frame 0 at scaleFactor
1.1 it builds the kernels once per geometry (tile rows and threads a
block, the macros CCT_FRONT_TILE_H, CCT_FRONT_THREADS, CCT_STAGE_TILE_H,
CCT_STAGE_THREADS of ``csrc/front.cu`` and ``csrc/stage.cu``) and prints,
per geometry, the device time of

  front        stages 1..n_dense-1 of the frontal face on its prep mask
  stage        all 30 stages of the upper body on gate AND grid
  stage 0      its dense pass alone (stages [0, 1))
  stage 1-29   its compacted passes alone, on the mask stage 0 leaves

after checking each output against the default geometry's. Further
-D flags on the command line are passed to every build; --quick times the
default geometry alone. The geometry the sources default to is the first
line; ``detect/records.py::TILE_H`` must
name the stage kernel's tile rows.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect import records
from cascadeclassifier_tpu_torch.detect.dense import dense_variance_gate
from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, build_pixel_canvas
from cascadeclassifier_tpu_torch.detect.front import front
from cascadeclassifier_tpu_torch.detect.integral import integral
from cascadeclassifier_tpu_torch.detect.stage import stage
from cascadeclassifier_tpu_torch.detect.tilted import tilted
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
from cascadeclassifier_tpu_torch.utils.synth import synth_frame

FRONT_GEOMETRIES = ((16, 256), (16, 128), (16, 512), (8, 128), (8, 256), (4, 128), (32, 256),
                    (32, 512))
STAGE_GEOMETRIES = ((16, 256), (16, 512), (16, 128), (8, 128), (8, 256), (8, 512), (32, 512),
                    (32, 1024))


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


def rebuild(flags, cascades, stage_tile_h: int):
    """Point the package at a build with these extra nvcc flags."""
    _build.NVCC_FLAGS = BASE_FLAGS + tuple(flags)
    _build._lib = None
    records.TILE_H = stage_tile_h
    for cas in cascades:
        cas._tables.clear()
    _build.lib()


def main(extra):
    quick = "--quick" in extra
    extra = [a for a in extra if a != "--quick"]
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
    sum_f, sq_f = integral(build_pixel_canvas(img, plan, eng._plan_tensors(plan)[0]))
    inv_f, alive_f = eng.prep(sum_f, sq_f, plan)

    det_b = TorchDetector(read_cascade_xml(os.path.join(data, "haarcascade_upperbody.xml")),
                          device=dev)
    cas_b = det_b.packed
    n_st = len(cas_b.stages)
    plan_b = det_b.plan_for(1920, 1080, 1.1, None, None)
    levels_b, grid_b = det_b.engine._plan_tensors(plan_b)[:2]
    px_b = build_pixel_canvas(img, plan_b, levels_b)
    sum_b, sq_b = integral(px_b)
    tilt_b = tilted(px_b, plan_b.is_top, int(plan_b.scaled_h.max()) + 1)
    gate_b, inv_b = dense_variance_gate(sum_b, sq_b, cas_b.win_w, cas_b.win_h,
                                        plan_b.out_h, plan_b.out_w)
    alive_b = gate_b & grid_b

    def run_front():
        return front(sum_f, inv_f, alive_f, cas, 1, eng.n_dense)

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


BASE_FLAGS = _build.NVCC_FLAGS

if __name__ == "__main__":
    main(sys.argv[1:])
