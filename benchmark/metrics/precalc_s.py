"""precalc_s: seconds of the stage trainer's feature precalculation (the
``FeatureCache`` build: every feature's values over the stage's samples,
and their sort) in the traced job, per job: the device-timeline length
of the program's ``boost.precalc`` spans (a CUDA event at each end, no
synchronization), summed under the job's root span (``train.job``).
None where the program records no such spans or no device times."""

from cascadeclassifier_tpu_torch.utils import profiling

JOB = "train.job"
PRECALC = "boost.precalc"


def read(ctx):
    spans = getattr(profiling, "spans", None)
    spans = spans() if spans else []
    jobs = {s.id for s in spans if s.name == JOB and s.parent is None}
    secs = [s.device_s for s in spans if s.name == PRECALC and s.root in jobs]
    if not secs or None in secs:
        return None
    return sum(secs) / len(jobs)
