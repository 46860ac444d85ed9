"""mfu_pct.train: the operations one job needs over the plain job's wall
and the H100's FP64 rate, in %.

Counted (the reference's work over the judged job): each stage's
feature values, 6k + 2 a feature of k rects a sample (3 corner adds and
a weight multiply-add a rect, the norm divide and a store), over the
F = 162336 BASIC features; each tree's split search, 8 a feature and
sample (``split_gather_roofline``); the miner's windows, each with its
norm (14) and 9 a tree of the stages it is held against."""

import numpy as np

from benchmark import peaks
from benchmark.reference.train import haar_basic

SPLIT_OPS = 8
NORM_OPS = 14
TREE_OPS = 9


def read(ctx):
    w = ctx.work
    if w is None or not ctx.job_wall_s:
        return None
    _, weights = haar_basic(w["win"], w["win"])
    per_sample = float(np.sum(6 * (weights != 0).sum(1) + 2))
    ops = 0.0
    for st in w["stages"]:
        ops += st["samples"] * per_sample + st["trees"] * SPLIT_OPS * w["features"] * st["samples"]
    ops += w.get("windows", 0) * NORM_OPS + w.get("tree_evals", 0) * TREE_OPS
    return peaks.mfu_pct(ops, ctx.job_wall_s)
