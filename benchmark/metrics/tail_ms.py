"""tail_ms: per frame, the wall ms of the fused engine's tail phase
(``Engine.detect(timings=)``, device synchronized after each phase)."""


def read(ctx):
    return (ctx.phase_ms or {}).get("tail")
