"""Times the HOG wrappers ``ops/hog.py::hog_integral_histogram`` and
``hog_responses`` through their public interface only, so that it also
times an older tree's kernels:

    python3 -m cascadeclassifier_tpu_torch.utils.time_hog
    PYTHONPATH=<other tree> python3 <this tree>/cascadeclassifier_tpu_torch/utils/time_hog.py

Needs a CUDA device and nvcc. The inputs are ``utils/tune_hog.py``'s:
3 072 windows at 24x24 like stage 0's sample set (1 000 synthetic marks,
``utils/train_data.py``, and crops of a synthetic clutter frame), the same
resized to 32x32, the HOG detector's batch (the first 8 192 windows of
``synth_frame(0)``'s grid at 24x24) and the first 1 024 of stage 0's,
whose 23 MB of histograms stay in the 50 MB L2. ``hog_responses`` takes
every variable of the catalog, but a dozen variables of eight features on
the detector's batch, as the predictor asks. Each call is timed three
times: CUDA events over 20 calls in a row (``ms``, which a short kernel's
host launch cost can bound), the host's time to queue one call (``host``,
20 calls without a sync), and the kernels' own device time from
torch.profiler (``device``, by kernel name). ``cuda_ms`` and
``device_ms`` are also ``chip_smoke.py``'s and ``utils/tune_hog.py``'s
timers; this module imports nothing of the package at its top, so that
it runs against an older tree.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

REPS = 20
DETECT_VARS = np.array([5, 40, 41, 77, 113, 150, 151, 190, 222, 260, 299, 323])
KERNELS = ("hog_hist_kernel", "hog_eval_plan_kernel", "hog_eval_kernel", "hog_eval_direct_kernel")


def inputs(dev):
    """{label: (k, h, w) uint8 windows on dev}."""
    from cascadeclassifier_tpu_torch.utils import train_data
    from cascadeclassifier_tpu_torch.utils.synth import synth_frame

    rng = np.random.default_rng(1)
    bg = train_data.background(1080, 1920, seed=100)
    ys, xs = rng.integers(0, 1080 - 24, 2072), rng.integers(0, 1920 - 24, 2072)
    s24 = np.concatenate([train_data.positives(1000, 24, seed=7),
                          np.stack([bg[y:y + 24, x:x + 24] for y, x in zip(ys, xs)])])
    s24 = torch.from_numpy(s24).to(dev)
    s32 = torch.nn.functional.interpolate(s24[:, None].float(), size=(32, 32), mode="bilinear",
                                          align_corners=False).round().clamp(0, 255)
    frame = torch.from_numpy(synth_frame(0)).to(dev)
    grid = frame.unfold(0, 24, 2).unfold(1, 24, 2).reshape(-1, 24, 24)[:8192].contiguous()
    return {"24x24 3072": s24, "32x32 3072": s32[:, 0].to(torch.uint8).contiguous(),
            "24x24 8192 detector": grid, "24x24 1024 in L2": s24[:1024]}


def var_ids(label: str, var_count: int):
    return DETECT_VARS if "detector" in label else np.arange(var_count)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean ms of fn() over reps calls in a row after one, CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn) -> float:
    """Mean host ms to queue fn() over REPS calls after one, no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    ms = (time.perf_counter() - t0) / REPS * 1e3
    torch.cuda.synchronize()
    return ms


def device_ms(fn, names, reps: int = REPS) -> dict:
    """{name: mean device ms of a launch of the kernels whose names hold
    name, over the launches torch.profiler traced in reps calls of fn()
    after one; 0.0 where none was traced}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        for name in names:
            if name in e.key:
                tot[name] += us
                count[name] += e.count
    return {name: tot[name] / max(count[name], 1) / 1e3 for name in names}


def main():
    import cascadeclassifier_tpu_torch
    from cascadeclassifier_tpu_torch.ops.features import hog_catalog
    from cascadeclassifier_tpu_torch.ops.hog import hog_integral_histogram, hog_responses

    if not torch.cuda.is_available():
        raise SystemExit("time_hog needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; the package at {cascadeclassifier_tpu_torch.__file__}; ms over {REPS} calls "
          f"after one", flush=True)
    for label, x in inputs(dev).items():
        n, h, w = x.shape
        hist, norm = hog_integral_histogram(x)
        flat = (hist.reshape(n, 9, -1), norm.reshape(n, -1))
        cat = hog_catalog(w, h)
        cells = torch.from_numpy(cat.cell_corner_offsets()).to(dev)
        ids = torch.from_numpy(var_ids(label, cat.var_count)).to(dev)
        for name, fn in (("hog_hist", lambda: hog_integral_histogram(x)),
                         ("hog_eval", lambda: hog_responses(*flat, cells, ids))):
            ms, host, d = cuda_ms(fn), host_ms(fn), device_ms(fn, KERNELS)
            print(f"{name} {label:20s} ({ids.numel()} vars): {ms:.4f} ms, host {host:.4f} ms, "
                  "device " + ", ".join(f"{k} {v:.4f}" for k, v in d.items() if v) + " ms",
                  flush=True)


if __name__ == "__main__":
    main()
