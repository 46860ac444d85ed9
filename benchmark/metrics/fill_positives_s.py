"""fill_positives_s: seconds of the trainer's positive fills over one
job (the program's ``timed("fill_positives")`` scopes, synchronized at
both ends), from the traced run's plain job."""


def read(ctx):
    return (ctx.timings or {}).get("fill_positives")
