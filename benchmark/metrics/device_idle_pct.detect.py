"""device_idle_pct.detect: 100 · (1 − busy / window) over the traced
pass, busy being the union of kernel, memcpy and memset intervals."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or ctx.counts is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
