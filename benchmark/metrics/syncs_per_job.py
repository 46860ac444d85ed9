"""syncs_per_job: the program's ``sync`` counts (``utils/profiling.py``:
each site where the host waits for the card) under the traced job's
root span (``train.job``), per job. None where the program records no
spans."""

from cascadeclassifier_tpu_torch.utils import profiling

JOB = "train.job"


def read(ctx):
    spans = getattr(profiling, "spans", None)
    jobs = [s for s in spans() if s.name == JOB and s.parent is None] if spans else []
    if not jobs:
        return None
    return sum(s.counts.get("sync", 0) for s in jobs) / len(jobs)
