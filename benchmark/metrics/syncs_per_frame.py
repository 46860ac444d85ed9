"""syncs_per_frame: the program's ``sync`` counts (``utils/profiling.py``:
each site where the host waits for the card) over the traced pass, per
frame: summed over the pass's root spans, over its frame roots
(``detect.frame``, or ``detect.raw_windows`` called on its own, as the
detection cell calls it). None where the program records no spans."""

from cascadeclassifier_tpu_torch.utils import profiling

FRAME_ROOTS = ("detect.frame", "detect.raw_windows")


def read(ctx):
    spans = getattr(profiling, "spans", None)
    roots = [s for s in spans() if s.parent is None] if spans else []
    frames = sum(s.name in FRAME_ROOTS for s in roots)
    if not frames:
        return None
    return sum(s.counts.get("sync", 0) for s in roots) / frames
