"""gate_ms: per frame, the wall ms of the stage engine's variance gate
phase (``StageEngine.detect(timings=)``: the torch ``dense_variance_gate``
over the plain stack, device synchronized after each phase)."""


def read(ctx):
    return (ctx.phase_ms or {}).get("gate")
