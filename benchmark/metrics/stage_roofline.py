"""stage_roofline: the stage kernel (``csrc/stage.cu``: the instances of
``cascade_tile.cuh``'s ``tile_kernel`` with ``kStage = true``, its fourth
template argument, as the trace names them) against the least time of its
work, in %.

Its work: every stage at the windows that evaluate it, stage 0 at every
window the gate and the x-walk leave, each later stage at the windows
still alive (early exit), counted by the reference; 6k + 3 operations a
stump of k rects. Bytes: every level's sum and tilted integrals read once
(int32 each, with the zero row and column) and, for every grid window,
its inverse norm (f32) and gate byte read and its alive byte written.
Time: the device time of those kernels in the traced pass."""

from benchmark import peaks

KERNEL = r"\btile_kernel<\s*\d+\s*,\s*\d+\s*,\s*\d+\s*,\s*true\b"


def read(ctx):
    if ctx.counts is None or ctx.trace is None:
        return None
    ops = peaks.walk_ops(ctx.cascade, ctx.counts, 0, len(ctx.cascade.stages))
    nbytes = sum((h + 1) * (w + 1) * 8 + n * 6 for h, w, n in ctx.counts.levels)
    return peaks.roofline_pct(ops, nbytes, ctx.trace.kernel_seconds(KERNEL))
