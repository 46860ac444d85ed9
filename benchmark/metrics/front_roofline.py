"""front_roofline: the dense front kernel (``csrc/front.cu``'s
``tile_kernel``) against the least time of its work, in %.

Its work: stages 1 … n−1 at every window that the gate, stage 0 and the
x-walk leave alive, n the first stage at which the trees summed from
stage 1 reach 250 (the fused engine's front). Operations: 6k + 3 a
stump of k rects for each window that evaluates its stage (early exit,
counted by the reference). Bytes: every level's sum integral read once
(int32) and, for every grid window, its inverse norm (f32) and alive
byte read and its alive byte written. Time: the device time of the
kernels named ``tile_kernel`` in the traced pass."""

from benchmark import peaks

FRONT_TREES = 250
KERNEL = r"\btile_kernel\b"


def front_end(cascade) -> int:
    trees = 0
    for si in range(1, len(cascade.stages)):
        trees += len(cascade.stages[si].feature)
        if trees >= FRONT_TREES:
            return si + 1
    return len(cascade.stages)


def read(ctx):
    if ctx.counts is None or ctx.trace is None:
        return None
    ops = peaks.walk_ops(ctx.cascade, ctx.counts, 1, front_end(ctx.cascade))
    nbytes = sum((h + 1) * (w + 1) * 4 + n * 6 for h, w, n in ctx.counts.levels)
    return peaks.roofline_pct(ops, nbytes, ctx.trace.kernel_seconds(KERNEL))
