"""What a run hands its per-layer metric readers (``metrics/<name>.py``).

Attributes a driver did not set read as None, so a reader that finds
nothing to read returns None and the metric is left out of the line.
Detection: ``trace`` (``trace.py::Traced``), ``frames`` (frames in each
traced pass), ``phase_ms`` (per-frame ms by phase, and "group"),
``plain_wall_s``, ``cascade`` and ``counts`` (the reference's cascade
and ``Counts`` over the traced frames). Training: ``trace``, ``jobs``
(jobs in the traced window), ``timings`` (the program's phase registry
over those jobs), ``work`` (the reference's per-job counts).
"""


class Context:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return None
