"""Driver of detection cells: a closed loop of frames through the
program's ``TorchDetector``.

Set-up reads the configuration's cascade XML into the program, builds
its detector with the configuration's options, makes the traffic's
frame pool from the seed and runs two frames to build and warm every
kernel (the pool's frames all have one size, so every shape is warm).

Window (``--trace 0``): one stream, closed loop over the pool. A frame
is handed over as a host uint8 array and is done when its grouped rects
are on the host: ``raw_windows`` then ``group``, which is
``detect_multi_scale`` with its raw windows kept for the check.
``frames_per_s`` is the frames done over the wall from the first
frame's start to the last one's end (the frame in flight at the close
finishes and counts); ``frame_ms_p95`` the 95th percentile of every
frame's latency.

Traced run (``--trace 1``): three passes over the pool, each frame
once: under torch.profiler (idle share, launches, kernel times, the
breakdown), plain (the wall that ``mfu_pct.detect`` divides by), and
with the engine's phase clock (``Engine.detect(timings=)``, a
synchronize after each phase) and the host clock around grouping.

Check: once the window has closed and the peak memory is read, the
program is freed and ``reference/detect.py`` computes each pool frame's
raw windows and grouped rects on the card. Every frame the run
produced is compared with them, as multisets: raw rects, and grouped
rects after the clip.
"""

from __future__ import annotations

import gc
import os
import time
from collections import Counter

import numpy as np
import torch

from benchmark import manifest, metrics_ctx
from benchmark.generate import video_pool
from benchmark.reference.cascade import read_cascade
from benchmark.reference.detect import Counts, ReferenceDetector, clip_rects, resize_exact
from benchmark.reference.group import group_rectangles


def _resize(frame, w, h, device="cpu"):
    return resize_exact(torch.as_tensor(frame, device=device), w, h).to(torch.uint8).cpu().numpy()


def _mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """Size of the symmetric difference of two multisets of rects."""
    ca = Counter(map(tuple, np.asarray(a).reshape(-1, 4).tolist()))
    cb = Counter(map(tuple, np.asarray(b).reshape(-1, 4).tolist()))
    return sum(((ca - cb) + (cb - ca)).values())


class Program:
    """The program's detector with the configuration's options."""

    def __init__(self, config: dict, device: str, options: dict | None = None):
        from cascadeclassifier_tpu_torch.detect.detector import make_detector, positions_to_rects
        from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml

        xml = os.path.join(config["_dir"], config["cascade"])
        opts = dict(config.get("options", {}), **(options or {}))
        self.det = make_detector(read_cascade_xml(xml), device=device, **opts)
        self.sf = float(config["scale_factor"])
        self.mn = int(config["min_neighbors"])
        self.max_det = int(config.get("max_det", 1 << 16))
        self.to_rects = positions_to_rects

    def frame(self, img, timings=None, group_ms=None):
        """One frame: (plan, raw window indices, grouped rects)."""
        plan, idx = self.det.raw_windows(img, self.sf, timings=timings)
        if len(idx) > self.max_det:
            raise RuntimeError(f"{len(idx)} raw windows exceed max_det={self.max_det}")
        t = time.perf_counter()
        rects = self.det.group(plan, idx, self.mn)
        if group_ms is not None:
            group_ms.append((time.perf_counter() - t) * 1e3)
        return plan, idx, rects


def run(spec: dict, seed: int, seconds: float, trace: bool, t0: float, log,
        device: str = "cuda") -> dict:
    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    prog = Program(cfg, device)
    t1 = time.perf_counter()
    frames = video_pool(traffic, seed, lambda f, w, h: _resize(f, w, h, device))
    t2 = time.perf_counter()
    pool = len(frames)
    for k in range(min(2, pool)):
        prog.frame(frames[k])
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: to the program built {t1 - t0:.3f}, {pool} frames of "
        f"{frames[0].shape[1]}x{frames[0].shape[0]} made {t2 - t1:.3f}, warm-up "
        f"{time.perf_counter() - t2:.3f}")

    outs = []  # (pool index, plan, raw indices, grouped rects)
    failed = 0
    metrics = {"setup_s": setup_s}
    ctx = metrics_ctx.Context(frames=pool)

    def one(i, **kw):
        nonlocal failed
        try:
            outs.append((i % pool, *prog.frame(frames[i % pool], **kw)))
        except RuntimeError as e:
            failed += 1
            log(f"frame {i} failed: {e}")

    if not trace:
        lat = []
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while time.perf_counter() < deadline:
            t = time.perf_counter()
            one(i)
            lat.append(time.perf_counter() - t)
            i += 1
        wall = time.perf_counter() - start
        metrics["frames_per_s"] = len(outs) / wall
        metrics["frame_ms_p95"] = float(np.percentile(np.asarray(lat) * 1e3, 95,
                                                      method="linear"))
        log(f"window {wall:.3f} s: {i} frames, p95 over {len(lat)} latencies, "
            f"median {np.median(lat) * 1e3:.3f} ms")
        attempted = i
    else:
        from benchmark.trace import Traced

        tr = Traced()
        with tr.window():
            for i in range(pool):
                one(i)
        start = time.perf_counter()
        for i in range(pool):
            one(i)
        _sync(device)
        ctx.plain_wall_s = time.perf_counter() - start
        timings, group_ms = {}, []
        for i in range(pool):
            one(i, timings=timings, group_ms=group_ms)
        ctx.trace = tr
        ctx.phase_ms = {k: v / pool for k, v in timings.items()}
        ctx.phase_ms["group"] = float(np.mean(group_ms)) if group_ms else None
        attempted = 3 * pool

    dev = _device(device)
    prog_raw = [(k, prog.to_rects(plan, idx), rects) for k, plan, idx, rects in outs]
    del prog, outs
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    checks = compare(cell, cfg, frames, prog_raw, device, log, ctx if trace else None)
    if trace:
        for m in spec["per_layer"]:
            metrics[m["name"]] = manifest.reader(m["name"]).read(ctx)
    return dict(correct=bool(prog_raw) and all(c["ok"] for c in checks) and failed == 0,
                attempted=attempted,
                failed=failed, metrics=metrics, device=dict(dev, **_trace_dev(ctx)),
                checks=checks, breakdown=ctx.trace.breakdown() if trace else None)


def compare(cell, cfg, frames, prog_raw, device, log, ctx=None) -> list:
    """Hold every frame the run produced against the reference."""
    if not prog_raw:
        return []
    ref_c = read_cascade(os.path.join(cfg["_dir"], cfg["cascade"]))
    ref = ReferenceDetector(ref_c, device)
    sf, mn = float(cfg["scale_factor"]), int(cfg["min_neighbors"])
    t = time.perf_counter()
    keys = sorted({k for k, _, _ in prog_raw})
    counts = Counts(len(ref_c.stages))
    want = {}
    for k, raw in zip(keys, ref.raw_batch([frames[k] for k in keys], sf, counts)):
        h, w = frames[k].shape
        want[k] = (raw, clip_rects(group_rectangles(raw, mn), w, h))
    if ctx is not None:
        ctx.cascade, ctx.counts = ref_c, counts
    raw_bad = sum(_mismatch(r, want[k][0]) for k, r, _ in prog_raw)
    grp_bad = sum(_mismatch(g, want[k][1]) for k, _, g in prog_raw)
    n_raw = sum(len(want[k][0]) for k, _, _ in prog_raw)
    log(f"reference: {len(want)} pool frames in {time.perf_counter() - t:.3f} s; "
        f"{len(prog_raw)} frames compared, {n_raw} raw windows expected")
    lim = cell["limits"]
    return [
        dict(name="raw_mismatch", value=raw_bad, limit=lim["raw_mismatch"], rule="<=",
             ok=raw_bad <= lim["raw_mismatch"]),
        dict(name="rect_mismatch", value=grp_bad, limit=lim["rect_mismatch"], rule="<=",
             ok=grp_bad <= lim["rect_mismatch"]),
    ]


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _device(device) -> dict:
    if not str(device).startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def _trace_dev(ctx) -> dict:
    tr = getattr(ctx, "trace", None)
    return {} if tr is None else {"busy_s": tr.busy_s, "window_s": tr.window_s}
