"""Readings that set a cell's limits: the program's sound runs over many
seeds, the lower-precision control's and the planted faults', in one
process.

    python3 -m benchmark.control --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--faults]

Each seed draws its own inputs here: the traffic's ``layout`` stream
comes from the seed, so every seed has scenes or a corpus of its own,
where the timed window runs on the traffic file's fixed layout.

Detection cells: each seed's pool once, frame by frame, through the
program as the configuration states it (the lower readings); on the
control seeds, through the program's own lower-precision path
(``exact=False``, f32 stage sums) and through the reference in the
program's place, computed with f32 stage sums and with bf16 feature
values (the upper readings).

Training cells: one job a seed, on the seed's first corpus, through the
program (the lower readings); on the control seeds, the reference training its own f64
cascade (judged, and its trees counted against the program's), the
reference trainer in f32 in the program's place and, with ``--faults``,
the reference trainer with each fault of ``reference/train.py::FAULTS``
planted (the upper readings).

Every reading is the comparison the cell's runs make, one JSON line
each. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import generate, manifest
from benchmark.drivers import detect, train
from benchmark.reference import train as ref


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


class _ReferenceProgram:
    """The detection reference in a lower precision, in the program's place."""

    def __init__(self, cfg, device, **precision):
        from benchmark.reference.cascade import read_cascade
        from benchmark.reference.detect import ReferenceDetector

        self.ref = ReferenceDetector(read_cascade(os.path.join(cfg["_dir"], cfg["cascade"])),
                                     device, **precision)
        self.sf, self.mn = float(cfg["scale_factor"]), int(cfg["min_neighbors"])

    def frames(self, imgs):
        from benchmark.reference.detect import clip_rects
        from benchmark.reference.group import group_rectangles

        h, w = imgs[0].shape
        return [(None, raw, clip_rects(group_rectangles(raw, self.mn), w, h))
                for raw in self.ref.raw_batch(imgs, self.sf)]

    @staticmethod
    def to_rects(_plan, raw):
        return raw


def inputs(traffic: dict, seed: int) -> dict:
    """The traffic with its layout stream drawn from the seed."""
    return dict(traffic, layout=generate.substream(seed, 1 << 24))


def detect_readings(spec, seed, device, program) -> dict:
    """Run the pool of ``seed`` once through ``program`` and compare."""
    frames = generate.video_pool(inputs(spec["traffic"], seed), seed,
                                 lambda f, w, h: detect._resize(f, w, h, device))
    if isinstance(program, _ReferenceProgram):
        outs = list(enumerate(program.frames(frames)))
        outs = [(k, *o) for k, o in outs]
    else:
        outs = [(k, *program.frame(f)) for k, f in enumerate(frames)]
    prog_raw = [(k, program.to_rects(plan, idx), rects) for k, plan, idx, rects in outs]
    checks = detect.compare(spec["cell"], spec["config"], frames, prog_raw, device, _log)
    return {c["name"]: c["value"] for c in checks}


def detect_runs(spec, args):
    cfg = spec["config"]
    runs = [("program", s) for s in args.seeds]
    runs += [("program_f32", s) for s in args.control_seeds]
    runs += [("reference_f32", s) for s in args.control_seeds]
    runs += [("reference_bf16", s) for s in args.control_seeds]
    lower = {"reference_f32": dict(acc=torch.float32), "reference_bf16": dict(val=torch.bfloat16)}
    prog = None
    for what, seed in runs:
        if what in lower:
            p = _ReferenceProgram(cfg, args.device, **lower[what])
        else:
            exact = what == "program"
            if prog is None or prog[0] != exact:
                prog = (exact, detect.Program(cfg, args.device, {"exact": exact}))
            p = prog[1]
        yield what, seed, lambda: detect_readings(spec, seed, args.device, p)


def _corpus(spec, seed, work) -> dict:
    t = dict(inputs(spec["traffic"], seed), win=spec["config"]["w"])
    return generate.train_corpora(t, seed, work)[0]


def train_readings(spec, seed, device, trainer) -> dict:
    """One job on the corpus of ``seed`` by ``trainer(corpus, out_dir)``,
    judged."""
    cfg = spec["config"]
    work = tempfile.mkdtemp(prefix="bench_control_")
    try:
        corpus = _corpus(spec, seed, work)
        xml = trainer(corpus, os.path.join(work, "job"))
        r = train.judge_xml(xml, cfg, corpus, work, device)
        return {k: v for k, v in r.items() if k != "stages"}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _reference_trainer(cfg, device, dtype, fault):
    def trainer(corpus, out_dir):
        from benchmark.reference.cascade import write_cascade

        c = ref.train(train.reference_corpus(cfg, corpus), train.params(cfg), device, dtype,
                      fault)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "cascade.xml")
        write_cascade(c, path)
        with open(path, "rb") as f:
            return f.read()
    return trainer


def trees_differing(xml_a: bytes, xml_b: bytes, work: str) -> int:
    """Trees (feature rects and weights, split, leaves) and stage
    thresholds that differ between two cascades, stage by stage."""
    from benchmark.reference.cascade import read_cascade

    cs = []
    for name, xml in (("a.xml", xml_a), ("b.xml", xml_b)):
        with open(os.path.join(work, name), "wb") as f:
            f.write(xml)
        cs.append(read_cascade(os.path.join(work, name)))
    a, b = cs
    n = abs(len(a.stages) - len(b.stages))
    for sa, sb in zip(a.stages, b.stages):
        n += abs(len(sa.feature) - len(sb.feature)) + int(sa.threshold != sb.threshold)
        for i in range(min(len(sa.feature), len(sb.feature))):
            fa, fb = sa.feature[i], sb.feature[i]
            same = (np.array_equal(a.rects[fa], b.rects[fb])
                    and np.array_equal(a.weights[fa], b.weights[fb])
                    and sa.split[i] == sb.split[i] and sa.left[i] == sb.left[i]
                    and sa.right[i] == sb.right[i])
            n += int(not same)
    return n


def reference_against_program(spec, seed, device, prog) -> dict:
    """The reference training its own f64 cascade on the corpus of
    ``seed``, judged, and counted against the program's job there."""
    cfg = spec["config"]
    work = tempfile.mkdtemp(prefix="bench_control_")
    try:
        corpus = _corpus(spec, seed, work)
        mine = prog.job(corpus, os.path.join(work, "job"))
        theirs = _reference_trainer(cfg, device, torch.float64, None)(
            corpus, os.path.join(work, "ref"))
        r = train.judge_xml(theirs, cfg, corpus, work, device)
        r = {k: v for k, v in r.items() if k != "stages"}
        r["trees_differing_from_program"] = trees_differing(mine, theirs, work)
        return r
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_runs(spec, args):
    cfg = spec["config"]
    prog = train.Program(cfg, args.device)
    for seed in args.seeds:
        yield "program", seed, lambda: train_readings(spec, seed, args.device, prog.job)
    for seed in args.control_seeds:
        yield "reference_f64", seed, lambda: reference_against_program(spec, seed, args.device,
                                                                       prog)
    kinds = [("reference_f32", torch.float32, None)]
    if args.faults:
        kinds += [(f"fault_{f}", torch.float64, f) for f in ref.FAULTS]
    for what, dtype, fault in kinds:
        tr = _reference_trainer(cfg, args.device, dtype, fault)
        for seed in args.control_seeds:
            yield what, seed, lambda: train_readings(spec, seed, args.device, tr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = manifest.cell(manifest.load(), args.workload)
    runs = {"detect": detect_runs, "train": train_runs}[spec["cell"]["driver"]]
    for what, seed, reading in runs(spec, args):
        t = time.perf_counter()
        r = reading()
        print(json.dumps(dict(what=what, seed=seed, seconds=time.perf_counter() - t, **r)),
              flush=True)


if __name__ == "__main__":
    main()
