"""Driver of detection cells whose cascade has tilted features: the
window, the traced passes and the check of ``drivers/detect.py``, with
the reference of ``reference/detect_tilted.py`` (its reader and
detector) in place of ``reference/detect.py``'s.

``detect.run`` and ``detect.compare`` name their reference directly, so
``run`` and ``compare`` below are their loops copied verbatim, with only
the reader and the detector of the reference changed (and the check's
log line gives the reference's raw windows of each pool frame besides);
the program, its frame, the window, the passes and the mismatch count
are ``detect.py``'s own pieces, imported. See ``drivers/detect.py`` for what each pass
measures and what the check compares.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from benchmark import manifest, metrics_ctx
from benchmark.drivers.detect import Program, _device, _mismatch, _resize, _sync, _trace_dev
from benchmark.generate import video_pool
from benchmark.reference.detect import Counts, clip_rects
from benchmark.reference.detect_tilted import ReferenceDetector, read_cascade
from benchmark.reference.group import group_rectangles


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
        f"{len(prog_raw)} frames compared, {n_raw} raw windows expected; raw windows a "
        f"pool frame: {[len(want[k][0]) for k in keys]}")
    lim = cell["limits"]
    return [
        dict(name="raw_mismatch", value=raw_bad, limit=lim["raw_mismatch"], rule="<=",
             ok=raw_bad <= lim["raw_mismatch"]),
        dict(name="rect_mismatch", value=grp_bad, limit=lim["rect_mismatch"], rule="<=",
             ok=grp_bad <= lim["rect_mismatch"]),
    ]
