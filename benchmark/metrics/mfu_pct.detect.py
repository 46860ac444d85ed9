"""mfu_pct.detect: the operations the traced frames need (``peaks.
frame_ops``: resize and integrals of every pyramid pixel, the variance
gate of every grid window, 6k + 3 for each stump of k rects that the
cascade walk evaluates, counted by the reference) over the plain pass's
wall and the H100's FP64 rate, in %."""

from benchmark import peaks


def read(ctx):
    if ctx.counts is None or not ctx.plain_wall_s:
        return None
    return peaks.mfu_pct(peaks.frame_ops(ctx.cascade, ctx.counts), ctx.plain_wall_s)
