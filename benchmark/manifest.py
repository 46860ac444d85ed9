"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is put together from four files of
its own: ``cells/<cell>.json`` (its driver and the limits its
comparison holds), ``configs/<config>.json``, ``traffic/<traffic>.json``
and, for each of its per-layer metrics, ``metrics/<metric>.py``. Adding
any of them takes a new file and a new entry in ``BENCHMARK.json``;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str, bench_dir: str) -> dict:
    path = os.path.join(bench_dir, kind, name + ".json")
    with open(path) as f:
        d = json.load(f)
    d["_dir"] = os.path.dirname(path)
    return d


def applies(metric: dict, cell: str, end_to_end: dict) -> bool:
    """Whether a metric is reported in a cell: its ``workloads`` list, or
    else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return applies(end_to_end[metric["moves"]], cell, end_to_end)
    return True


def cell(manifest: dict, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """Everything one cell runs with: the workload entry, its cell,
    configuration and traffic files, and its end-to-end and per-layer
    metric entries."""
    entry = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    return dict(
        entry=entry,
        cell=_json("cells", name, bench_dir),
        config=_json("configs", entry["config"], bench_dir),
        traffic=_json("traffic", entry["traffic"], bench_dir),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name, e2e)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name, e2e)],
    )


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The module ``metrics/<name>.py``; its ``read(ctx)`` returns the
    metric's value, or None where the run holds nothing to read."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    module = "benchmark_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
