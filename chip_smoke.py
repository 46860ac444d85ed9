"""Smoke run of the PyTorch/CUDA port on one GPU at 1080p.

    python3 chip_smoke.py

Drives cascadeclassifier_tpu_torch's main path — multi-scale detection
with haarcascade_frontalface_alt.xml (22 stages) on 1920x1080 synthetic
frames, scaleFactor 1.1 — through TorchDetector on cuda:0, and checks it:

  (a) build     compile the three CUDA kernels from csrc/ (seconds)
  (b) integral  kernel 1 vs its plain twin on frame 0's canvas (equal)
  (c) front     kernel 2 vs its twin over stages 1..n_dense-1, on the
                ystep-2 and ystep-1 rows separately; survivors > 0
  (d) patchify  kernel 3 vs its twin on the front's survivors, at a
                capacity equal to and larger than the live count
  (e) e2e       frames 0-3 through the kernels equal the twin path on
                the card; frames 0 and 1 equal the committed OpenCV
                golden at minNeighbors 3 and 0; every kernel launched
  (f) timing    frames/s over 8 frames after a warm-up; per-kernel time
                against its twin at the main path's shapes

Exits non-zero on any mismatch, and without CUDA. The last line is
{"ok": true, "device": {...}}.
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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cascadeclassifier_tpu_torch import _build
    from cascadeclassifier_tpu_torch.detect.detector import TorchDetector, build_pixel_canvas
    from cascadeclassifier_tpu_torch.detect.front import front
    from cascadeclassifier_tpu_torch.detect.integral import integral
    from cascadeclassifier_tpu_torch.detect.patchify import patchify
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    dev = torch.device("cuda:0")
    data = os.path.join(HERE, "cascadeclassifier_tpu_torch", "data")
    model = read_cascade_xml(os.path.join(data, "haarcascade_frontalface_alt.xml"))
    with open(os.path.join(data, "smoke_golden_1080p.json")) as f:
        golden = json.load(f)
    H, W, SF = golden["height"], golden["width"], golden["scale_factor"]

    # (a) build
    t0 = time.perf_counter()
    _build.lib()
    print(f"(a) build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)} -> sm_90a)", flush=True)

    det = TorchDetector(model, exact=False, device=dev)
    ref = TorchDetector(model, exact=False, device=dev, impl="ref")
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

    errs = {}

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
    launches = dict(_build.LAUNCHES)
    for name in ("integral", "front", "patchify"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
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
          f"launches {launches}", flush=True)

    # (f) timing
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    det.detect_multi_scale_batch(frames[:1], SF, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.detect_multi_scale_batch(frames, SF, 3)
    torch.cuda.synchronize()
    fps = len(frames) / (time.perf_counter() - t0)
    print(f"(f) timing: {fps:.2f} frames/s at 1080p over {len(frames)} frames "
          f"(sf {SF}, minNeighbors 3) on {smi}", flush=True)
    phases = {}
    t0 = time.perf_counter()
    for f in frames:
        plan_f, idx_f = det.raw_windows(f, SF, timings=phases)
        tg = time.perf_counter()
        TorchDetector.group(plan_f, idx_f, 3)
        phases["group"] = phases.get("group", 0.0) + (time.perf_counter() - tg) * 1e3
    total = (time.perf_counter() - t0) * 1e3
    phases["other"] = total - sum(phases.values())
    print("(f) ms/frame by phase (device synchronized after each): " + ", ".join(
        f"{k} {v / len(frames):.2f}" for k, v in phases.items()
    ) + f"; total {total / len(frames):.2f}", flush=True)

    ncells = n_front
    timed = {
        "integral": (lambda: integral(px), lambda: integral(px, impl="ref")),
        "front": (lambda: front(s_k, inv_nf, alive0, cas, 1, eng.n_dense),
                  lambda: front(s_k, inv_nf, alive0, cas, 1, eng.n_dense, impl="ref")),
        "patchify": (lambda: patchify(s_k, r, c, ncells, cas.win_w, cas.win_h),
                     lambda: patchify(s_k, r, c, ncells, cas.win_w, cas.win_h, impl="ref")),
    }
    meta = {
        "integral": ("cascadeclassifier_tpu_torch/csrc/integral.cu",
                     "cascadeclassifier_tpu/detect/pallas_integral.py:50"),
        "front": ("cascadeclassifier_tpu_torch/csrc/front.cu",
                  "cascadeclassifier_tpu/detect/pallas_front.py:610; "
                  "cascadeclassifier_tpu/detect/pallas_front.py:75"),
        "patchify": ("cascadeclassifier_tpu_torch/csrc/patchify.cu",
                     "cascadeclassifier_tpu/detect/compact.py:675"),
    }
    kernels = []
    for name, (fk, fr) in timed.items():
        ms = cuda_ms(fk, 20)
        plain_ms = cuda_ms(fr, 3)
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
        })
        print(f"(f) {name}: kernel {ms:.3f} ms, plain twin {plain_ms:.3f} ms", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
