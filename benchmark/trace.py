"""The device trace of a traced window, read from torch.profiler.

``Traced`` runs a scope under the profiler (CPU and CUDA activity), with
the window itself marked by a ``bench.window`` range, writes the Chrome
trace into the run's temporary directory, reads it back and deletes it.
What it keeps:

  - kernels: (name, start µs, duration µs) of every kernel in the window
  - busy_s: the union of kernel, memcpy and memset intervals in the window
  - window_s: the window's length on the trace's clock
  - launches: kernel launches the host made in the window
  - gaps: (label, µs) of every interval in which the device ran nothing,
    labelled by the innermost host operation open at its start
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchCooperativeKernel)")


class Traced:
    def __init__(self):
        self.kernels = []
        self.busy_s = 0.0
        self.window_s = 0.0
        self.launches = 0
        self.gaps = []

    @contextlib.contextmanager
    def window(self):
        """Profile the scope; the trace is read when it closes."""
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield self
                if cuda:
                    torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._read(events)

    def _read(self, events):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w0 = min(float(e["ts"]) for e in win)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
        self.window_s = (w1 - w0) * 1e-6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts + dur < w0 or ts > w1:
                continue
            cat = e.get("cat", "")
            if cat in _DEVICE_CATS:
                a, b = max(ts, w0), min(ts + dur, w1)
                dev.append((a, b))
                if cat == "kernel":
                    self.kernels.append((e["name"], ts, dur))
            elif cat == "cuda_runtime" and _LAUNCH.match(e.get("name", "")):
                self.launches += 1
            elif cat in ("cpu_op", "user_annotation", "python_function") and e["name"] != WINDOW:
                host.append((ts, ts + dur, e["name"]))
        dev.sort()
        busy, gaps, cur = 0.0, [], w0
        for a, b in dev:
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if cur < w1:
            gaps.append((cur, w1))
        self.busy_s = busy * 1e-6
        host.sort()
        starts = [h[0] for h in host]
        for a, b in gaps:
            self.gaps.append((_label(host, starts, a), b - a))

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.kernels if rx.search(n)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for n, _, d in self.kernels:
            ops[_short(n)] += d * 1e-6
        idle = defaultdict(float)
        for label, d in self.gaps:
            idle[label] += d * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def _label(host, starts, t) -> str:
    """The innermost host event open at time t (the latest-starting one
    that has not ended), or "host" where none is."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(i - 400, -1), -1):
        a, b, name = host[j]
        if a <= t < b:
            best = name
            break
    return _short(best) if best else "host"


def _short(name: str) -> str:
    """A kernel or host op's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]
