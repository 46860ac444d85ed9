"""tilted_roofline: the tilted canvas kernel (``csrc/tilted.cu``'s
``tilted_kernel``) against the least time of its work, in %: every level
pixel read once (uint8) and its tilted integral written once (int32, with
the zero row and column). Operations: 4 integer adds a pixel (the row
recurrence T[y][x] = T[y−1][x−1] + T[y−1][x+1] − T[y−2][x] + I[y][x] +
I[y−1][x] with the last two pixels' sum shared down a column). Time: its
device time in the traced pass."""

from benchmark import peaks

KERNEL = r"\btilted_kernel\b"
OPS_PER_PIXEL = 4


def read(ctx):
    if ctx.counts is None or ctx.trace is None:
        return None
    nbytes = sum(h * w + (h + 1) * (w + 1) * 4 for h, w, _ in ctx.counts.levels)
    ops = sum(h * w for h, w, _ in ctx.counts.levels) * OPS_PER_PIXEL
    return peaks.roofline_pct(ops, nbytes, ctx.trace.kernel_seconds(KERNEL))
