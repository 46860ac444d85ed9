"""group_ms: per frame, host-clock ms around ``TorchDetector.group``
(grouping the raw windows and clipping them)."""


def read(ctx):
    return (ctx.phase_ms or {}).get("group")
