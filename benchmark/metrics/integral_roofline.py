"""integral_roofline: the integral kernels (``csrc/integral.cu``:
``band_sums``, ``band_carry``, ``band_apply``) against the least time of
their work, in %: every level pixel read once (uint8) and its sum and
squared-sum integrals written once (int32 each, with the zero row and
column). Time: their device time in the traced pass."""

from benchmark import peaks

KERNEL = r"\bband_(sums|carry|apply)\b"


def read(ctx):
    if ctx.counts is None or ctx.trace is None:
        return None
    nbytes = sum(h * w + (h + 1) * (w + 1) * 8 for h, w, _ in ctx.counts.levels)
    ops = sum(h * w for h, w, _ in ctx.counts.levels) * peaks.INTEGRAL_OPS_PER_PIXEL
    return peaks.roofline_pct(ops, nbytes, ctx.trace.kernel_seconds(KERNEL))
