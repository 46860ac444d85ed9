"""split_gather_roofline: the regression split kernel
(``csrc/split_scan.cu``'s ``split_scan_kernel``) against the least time
of a job's split searches, in %.

Work: for every tree of every stage (the job's cascade), each of the F
features' N values (f32) and sort positions (int32) read once, the
per-sample weight and weighted response (f64 each) and mask byte read
once, each feature's quality and threshold (f64 each) written once:
8·F·N + 17·N + 16·F bytes; operations 8 a (feature, sample): two prefix
adds, the quality's two squares, two divides, an add, a compare. N is
the stage's samples (positives and negatives, the reference's count).
Time: the kernel's device time over the traced job."""

from benchmark import peaks

KERNEL = r"\bsplit_scan_kernel\b"
OPS_PER_VALUE = 8


def read(ctx):
    if ctx.work is None or ctx.trace is None:
        return None
    f = ctx.work["features"]
    nbytes = ops = 0
    for st in ctx.work["stages"]:
        n, t = st["samples"], st["trees"]
        nbytes += t * (8 * f * n + 17 * n + 16 * f)
        ops += t * OPS_PER_VALUE * f * n
    return peaks.roofline_pct(ops, nbytes, ctx.trace.kernel_seconds(KERNEL))
