"""train_stage_s: seconds of the stage trainer (precalculation, split search, boosting) over one
job (the program's ``timed("train_stage")`` scopes, synchronized at
both ends), from the traced run's plain job."""


def read(ctx):
    return (ctx.timings or {}).get("train_stage")
