"""Driver of training cells: back-to-back traincascade jobs through the
program's ``CascadeTrainer``.

Set-up writes the traffic's corpora (each a ``.vec`` of positives and a
``bg.txt`` over shared background frames) into the run's temporary
directory, in the seed's order, and runs one whole job, which builds and
warms every kernel and shape the window's jobs use.

Window (``--trace 0``): jobs back to back in rounds, one job a corpus in
the seed's order, each a fresh trainer with the configuration's
parameters writing into a fresh directory, until ``--seconds`` have
passed; the round in flight then finishes and counts, so every run does
the same work. ``train_s`` is the wall from the first job's start to the
last job's end over the jobs done.

Traced run (``--trace 1``): one job on the seed's first corpus under
torch.profiler (idle share, kernel times, the breakdown), then one plain
job, whose phase timings (the program's ``utils/profiling.timed``
registry) and wall the per-layer metrics read.

Check: once the window has closed, the peak memory is read and the
program is freed, ``reference/train.py::judge`` follows one job's
cascade, drawn from the seed, stage by stage on its own samples and
weights. Its four numbers are compared: each tree's split and leaves
(``split_gap``, ``leaf_ulps``), each stage's threshold
(``threshold_gap``), and where stages and trees end against the stop
rule (``stop_mismatch``), so a job that stops a stage or the cascade
early, or writes a wrong threshold, is not correct.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time

import torch

from benchmark import generate, manifest, metrics_ctx
from benchmark.drivers.detect import _device, _sync, _trace_dev
from benchmark.reference import train as ref


class Program:
    """The program's trainer with the configuration's parameters."""

    def __init__(self, config: dict, device: str):
        from cascadeclassifier_tpu_torch.train.boost import BoostParams
        from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer
        from cascadeclassifier_tpu_torch.utils import profiling

        if (config["featureType"], config["mode"], config["bt"], config["maxDepth"]) != \
                ("HAAR", "BASIC", "GAB", 1):
            raise ValueError("the training driver runs Haar BASIC GAB stumps")
        self.cfg, self.device, self.profiling = config, device, profiling
        self.make = lambda: CascadeTrainer(
            win_w=int(config["w"]), win_h=int(config["h"]), haar_mode=config["mode"],
            boost=BoostParams(min_hit_rate=float(config["minHitRate"]),
                              max_false_alarm=float(config["maxFalseAlarmRate"]),
                              weight_trim_rate=float(config["weightTrimRate"]),
                              max_depth=int(config["maxDepth"]),
                              weak_count=int(config["maxWeakCount"])),
            precalc_val_mb=float(config["precalcValBufSize"]),
            precalc_idx_mb=float(config["precalcIdxBufSize"]), device=device)

    def job(self, corpus: dict, out_dir: str) -> bytes:
        """One traincascade job into out_dir; returns its cascade.xml."""
        c = self.cfg
        with contextlib.redirect_stdout(sys.stderr):  # the trainer's transcript
            self.make().train(out_dir, corpus["vec"], corpus["bg"], num_pos=int(c["numPos"]),
                              num_neg=int(c["numNeg"]), num_stages=int(c["numStages"]),
                              verbose=False)
        with open(os.path.join(out_dir, "cascade.xml"), "rb") as f:
            return f.read()


def run(spec: dict, seed: int, seconds: float, trace: bool, t0: float, log,
        device: str = "cuda") -> dict:
    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    work = tempfile.mkdtemp(prefix="bench_train_")
    try:
        return _run(spec, cfg, traffic, cell, seed, seconds, trace, t0, log, device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(spec, cfg, traffic, cell, seed, seconds, trace, t0, log, device, work):
    prog = Program(cfg, device)
    t1 = time.perf_counter()
    corpora = generate.train_corpora(dict(traffic, win=cfg["w"]), seed, work)
    t2 = time.perf_counter()
    n_jobs = [0]

    def job(corpus):
        d = os.path.join(work, f"job{n_jobs[0]}")
        n_jobs[0] += 1
        try:
            return prog.job(corpus, d)
        finally:
            shutil.rmtree(d, ignore_errors=True)

    job(corpora[0])  # warm-up: every kernel built, every shape met
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: to the program built {t1 - t0:.3f}, corpora {t2 - t1:.3f}, "
        f"warm-up job {time.perf_counter() - t2:.3f}")
    metrics = {"setup_s": setup_s}
    ctx = metrics_ctx.Context()
    outs, failed = [], 0  # (corpus, cascade.xml)

    def timed_job(corpus):
        nonlocal failed
        try:
            outs.append((corpus, job(corpus)))
        except (RuntimeError, ValueError) as e:
            failed += 1
            log(f"job failed: {e}")

    if not trace:
        start = time.perf_counter()
        while True:  # whole rounds, one job a corpus
            for corpus in corpora:
                timed_job(corpus)
            if time.perf_counter() - start >= seconds:
                break
        wall = time.perf_counter() - start
        done = len(outs)
        metrics["train_s"] = wall / done if done else None
        log(f"window {wall:.3f} s: {done + failed} jobs in rounds of {len(corpora)}")
        attempted = done + failed
    else:
        from benchmark.trace import Traced

        tr = Traced()
        with tr.window():
            timed_job(corpora[0])
        prog.profiling.reset_timings()
        start = time.perf_counter()
        timed_job(corpora[0])
        ctx.job_wall_s = time.perf_counter() - start
        ctx.timings = {k: float(sum(v)) for k, v in prog.profiling.timings().items()}
        ctx.trace = tr
        attempted = 2

    dev = _device(device)
    del prog
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    checks = compare(cell, cfg, outs, work, device, log, seed, ctx)
    if trace:
        for m in spec["per_layer"]:
            metrics[m["name"]] = manifest.reader(m["name"]).read(ctx)
    return dict(correct=bool(checks) and all(c["ok"] for c in checks) and failed == 0,
                attempted=attempted, failed=failed, metrics=metrics,
                device=dict(dev, **_trace_dev(ctx)), checks=checks,
                breakdown=ctx.trace.breakdown() if trace else None)


def reference_corpus(cfg, corpus) -> ref.Corpus:
    win = int(cfg["w"])
    return ref.Corpus(vec=ref.read_vec(corpus["vec"], win),
                      backgrounds=[ref.read_pgm(n) for n in _bg_names(corpus["bg"])],
                      num_pos=int(cfg["numPos"]), num_neg=int(cfg["numNeg"]),
                      num_stages=int(cfg["numStages"]), win=win)


def _bg_names(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def params(cfg) -> ref.BoostParams:
    return ref.BoostParams(min_hit_rate=float(cfg["minHitRate"]),
                           max_false_alarm=float(cfg["maxFalseAlarmRate"]),
                           weight_trim_rate=float(cfg["weightTrimRate"]),
                           weak_count=int(cfg["maxWeakCount"]))


def judge_xml(xml: bytes, cfg, corpus, work, device, counter=None) -> dict:
    path = os.path.join(work, "judged.xml")
    with open(path, "wb") as f:
        f.write(xml)
    from benchmark.reference.cascade import read_cascade

    return ref.judge(read_cascade(path), reference_corpus(cfg, corpus), params(cfg), device,
                     counter)


def compare(cell, cfg, outs, work, device, log, seed, ctx=None) -> list:
    """Judge one job of the window, drawn from the seed."""
    if not outs:
        return []
    pick = generate.substream(seed, 1 << 23) % len(outs)
    corpus, xml = outs[pick]
    t = time.perf_counter()
    counter = {}
    r = judge_xml(xml, cfg, corpus, work, device, counter)
    if ctx is not None:
        ctx.work = dict(r, **counter)
    log(f"reference: judged job {pick} of {len(outs)} (corpus {corpus['index']}, {r['trees']} "
        f"trees, {len(r['stages'])} stages) in {time.perf_counter() - t:.3f} s")
    lim = cell["limits"]
    return [dict(name=name, value=r[name], limit=lim[name], rule="<=",
                 ok=bool(r[name] <= lim[name]))
            for name in ("split_gap", "leaf_ulps", "threshold_gap", "stop_mismatch")]
