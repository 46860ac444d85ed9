"""prep_ms: per frame, the wall ms of the fused engine's prep phase
(``Engine.detect(timings=)``, device synchronized after each phase)."""


def read(ctx):
    return (ctx.phase_ms or {}).get("prep")
