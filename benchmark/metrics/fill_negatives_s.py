"""fill_negatives_s: seconds of the trainer's negative fills (mining) over one
job (the program's ``timed("fill_negatives")`` scopes, synchronized at
both ends), from the traced run's plain job."""


def read(ctx):
    return (ctx.timings or {}).get("fill_negatives")
