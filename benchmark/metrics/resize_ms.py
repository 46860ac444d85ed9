"""resize_ms: per frame, the wall ms of the detector's resize phase
(``Engine.detect(timings=)``, device synchronized after each phase)."""


def read(ctx):
    return (ctx.phase_ms or {}).get("resize")
