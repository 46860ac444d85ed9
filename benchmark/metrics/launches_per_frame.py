"""launches_per_frame: kernel launches the host made in the traced pass
(``cudaLaunchKernel`` and kin, torch's and the program's), per frame."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.frames or ctx.counts is None:
        return None
    return tr.launches / ctx.frames
