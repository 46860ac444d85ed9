"""The harness on the CPU: traffic, arithmetic, the manifest and the guard."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import generate, guard, manifest, peaks
from benchmark.reference.detect import Counts

BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT
SMALL_VIDEO = dict(kind="video", pool=3, faces=6, base_width=320, base_height=180, upscale=2,
                   face_size=[15, 40], face_grey=[180, 230], eye_grey=[30, 80],
                   mouth_grey=[40, 90], layout=1)


def _resize(img, w, h):
    import torch

    from benchmark.reference.detect import resize_exact
    return resize_exact(torch.as_tensor(img), w, h).to(torch.uint8).numpy()


# ---------------------------------------------------------------- traffic


def test_video_pool_is_seeded():
    big = 2**31 + 12345
    a = generate.video_pool(SMALL_VIDEO, big, _resize)
    b = generate.video_pool(SMALL_VIDEO, big, _resize)
    c = generate.video_pool(SMALL_VIDEO, big + 1, _resize)
    assert len(a) == 3 and a[0].shape == (360, 640) and a[0].dtype == np.uint8
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert len({x.tobytes() for x in a}) == 3


def test_every_seed_draws_the_same_scenes():
    """Seeds differ in the pool's order and noise (±8), not in its scenes."""
    a = generate.video_pool(SMALL_VIDEO, 11, _resize)
    b = generate.video_pool(SMALL_VIDEO, 2**31 + 7, _resize)
    match = [min(range(len(b)), key=lambda j: np.abs(x.astype(int) - b[j]).mean()) for x in a]
    assert sorted(match) == list(range(len(b)))
    for x, j in zip(a, match):
        assert np.abs(x.astype(int) - b[j]).max() <= 16
    assert match != list(range(len(b))) or not np.array_equal(a[0], b[0])
    sizes = generate.spread(20, 15, 40)
    assert sizes.min() == 15 and sizes.max() < 40 and len(set(sizes.tolist())) > 10


def test_upscale_is_exact_bilinear():
    base = generate.synth_scene(5, 40, 60, faces=2)
    up = _resize(base, 120, 80)
    assert up.shape == (80, 120)
    # INTER_LINEAR_EXACT at 2x: every output is a 1:3 blend of neighbours
    assert abs(int(up[41, 61]) - (int(base[20, 30]) * 9 + int(base[20, 31]) * 3
                                  + int(base[21, 30]) * 3 + int(base[21, 31])) / 16) <= 1


def test_train_corpora_are_seeded(tmp_path):
    t = dict(win=24, vec_count=30, backgrounds=2, bg_height=100, bg_width=120, layout=1,
             corpora=3)
    out = {}
    for name, seed in (("a", 2**31 + 3), ("b", 2**31 + 3), ("c", 2**31 + 5)):
        os.makedirs(tmp_path / name)
        out[name] = generate.train_corpora(t, seed, str(tmp_path / name))
    a, b, c = out["a"], out["b"], out["c"]
    assert [x["index"] for x in a] == [x["index"] for x in b]
    assert sorted(x["index"] for x in a) == sorted(x["index"] for x in c) == [0, 1, 2]
    for x, y in zip(a, b):
        assert open(x["vec"], "rb").read() == open(y["vec"], "rb").read()
    # the same corpora for every seed, different from each other
    by_index = {x["index"]: x for x in c}
    for x in a:
        np.testing.assert_array_equal(x["positives"], by_index[x["index"]]["positives"])
    assert not np.array_equal(a[0]["positives"], a[1]["positives"])
    from benchmark.reference.train import read_pgm, read_vec
    np.testing.assert_array_equal(read_vec(a[0]["vec"], 24), a[0]["positives"])
    names = [line.strip() for line in open(a[0]["bg"])]
    np.testing.assert_array_equal(read_pgm(names[1]), a[0]["backgrounds"][1])


def test_control_readings_draw_inputs_from_the_seed():
    """The limits' readings run on scenes and corpora of each seed's own."""
    from benchmark import control

    a = control.inputs(SMALL_VIDEO, 2**31 + 1)
    b = control.inputs(SMALL_VIDEO, 2**31 + 2)
    assert a["layout"] != b["layout"] != SMALL_VIDEO["layout"]
    fa = generate.video_pool(a, 2**31 + 1, _resize)
    fb = generate.video_pool(dict(a, layout=SMALL_VIDEO["layout"]), 2**31 + 1, _resize)
    # other scenes, not only other noise
    assert min(np.abs(x.astype(int) - y).max() for x in fa for y in fb) > 16


# ------------------------------------------------------------- arithmetic


def test_roofline_and_mfu_by_hand():
    # 1 GB over 3.35 TB/s is 298.5 µs; 1e12 operations at 34 T is 29.4 ms
    assert peaks.least_seconds(0, 1e9) == pytest.approx(1e9 / 3.35e12)
    assert peaks.least_seconds(1e12, 1e9) == pytest.approx(1e12 / 34e12)
    assert peaks.roofline_pct(0, 3.35e9, 2e-3) == pytest.approx(50.0)
    assert peaks.roofline_pct(1, 1, 0) is None
    assert peaks.mfu_pct(34e12, 2.0) == pytest.approx(50.0)
    assert peaks.mfu_pct(0, 1.0) is None


def test_cascade_operations_by_hand():
    from benchmark.reference.cascade import Cascade, Stage

    rects = np.zeros((3, 3, 4), np.int64)
    weights = np.array([[-1, 2, 0], [-1, 2, 2], [-1, 2, 0]], np.float32)
    st = [Stage(0.0, np.array([0, 1]), np.zeros(2, np.float32), np.zeros(2, np.float32),
                np.zeros(2, np.float32)),
          Stage(0.0, np.array([2]), np.zeros(1, np.float32), np.zeros(1, np.float32),
                np.zeros(1, np.float32))]
    c = Cascade(20, 20, st, rects, weights)
    # stage 0: stumps of 2 and 3 rects, 15 + 21; stage 1: 15
    assert peaks.stage_ops(c) == [36, 15]
    counts = Counts(2)
    counts.levels = [(10, 20, 7)]
    counts.stage_windows[:] = [5, 2]
    assert peaks.walk_ops(c, counts) == 5 * 36 + 2 * 15
    assert peaks.walk_ops(c, counts, 1, 2) == 30
    assert peaks.frame_ops(c, counts) == 200 * 13 + 7 * 14 + 210


def test_metric_readers_by_hand():
    from benchmark.metrics_ctx import Context

    class Tr:
        busy_s, window_s, launches = 0.25, 1.0, 300

        def kernel_seconds(self, pattern):
            return {r"\bband_(sums|carry|apply)\b": 1e-3}.get(pattern, 0.0)

    counts = Counts(1)
    counts.levels = [(99, 99, 10)]
    ctx = Context(trace=Tr(), frames=3, counts=counts, cascade=None)
    assert manifest.reader("device_idle_pct.detect").read(ctx) == pytest.approx(75.0)
    assert manifest.reader("launches_per_frame").read(ctx) == pytest.approx(100.0)
    # 99·99 + 100·100·8 bytes over 3.35 TB/s, against 1 ms
    want = 100 * (99 * 99 + 100 * 100 * 8) / 3.35e12 / 1e-3
    assert manifest.reader("integral_roofline").read(ctx) == pytest.approx(want)
    assert manifest.reader("front_roofline").read(Context()) is None
    assert manifest.reader("resize_ms").read(Context()) is None
    work = dict(features=10, win=24, stages=[dict(samples=100, trees=2)])
    ctx = Context(trace=Tr(), work=work)
    # no split kernel in the trace: nothing to read
    assert manifest.reader("split_gather_roofline").read(ctx) is None


# --------------------------------------------------------------- manifest


def test_manifest_finds_every_file():
    m = manifest.load()
    assert {c["name"] for c in m["configs"]} == {"frontal_alt", "haar24_gab"}
    for c in m["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in m["workloads"]:
        spec = manifest.cell(m, w["name"])
        assert spec["cell"]["driver"] in ("detect", "train")
        assert spec["traffic"]["kind"] in ("video", "train")
        names = {e["name"] for e in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
        for metric in spec["per_layer"]:
            assert callable(manifest.reader(metric["name"]).read)


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest.load()
    bench = root / "benchmark"
    (bench / "configs" / "frontal_alt2x.json").write_text(
        (bench / "configs" / "frontal_alt.json").read_text().replace('"scale_factor": 1.1',
                                                                     '"scale_factor": 1.2'))
    (bench / "traffic" / "video720.json").write_text(json.dumps(dict(SMALL_VIDEO, pool=2)))
    (bench / "cells" / "frontal_alt2x.video720.json").write_text(
        json.dumps({"driver": "detect", "limits": {"raw_mismatch": 0, "rect_mismatch": 0}}))
    (bench / "metrics" / "raw_per_frame.py").write_text("def read(ctx):\n    return 1.0\n")
    m["configs"].append(dict(m["configs"][0], name="frontal_alt2x",
                             file="benchmark/configs/frontal_alt2x.json"))
    m["workloads"].append(dict(name="frontal_alt2x.video720", config="frontal_alt2x",
                               traffic="video720", chips=1, why="a test"))
    m["per_layer"].append(dict(name="raw_per_frame", unit="windows", better="lower",
                               source="program_counter", layer="fused engine",
                               moves="frames_per_s", workloads=["frontal_alt2x.video720"]))
    for e in m["end_to_end"]:
        if e["name"] in ("frames_per_s", "frame_ms_p95"):
            e["workloads"].append("frontal_alt2x.video720")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    spec = manifest.cell(manifest.load(str(root)), "frontal_alt2x.video720", str(bench))
    assert spec["config"]["scale_factor"] == 1.2 and spec["traffic"]["pool"] == 2
    assert [p["name"] for p in spec["per_layer"]] == ["raw_per_frame"]
    assert manifest.reader("raw_per_frame", str(bench)).read(None) == 1.0
    assert {e["name"] for e in spec["end_to_end"]} == {"frames_per_s", "frame_ms_p95", "setup_s"}


# ------------------------------------------------------------------ guard


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["cascadeclassifier_tpu_torch.detect", "numpy"]) == []
    assert guard.forbidden_modules(["jax.numpy", "os"]) == ["jax"]
    assert guard.forbidden_modules(["cascadeclassifier_tpu.detect.engine"]) == [
        "cascadeclassifier_tpu"]
    assert guard.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert guard.forbidden_modules(["jaxtyping"]) == []


def test_nothing_the_benchmark_loads_is_jax():
    code = (
        "import importlib, os, sys, pkgutil\n"
        "import benchmark, benchmark.run, benchmark.control\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from benchmark import manifest\n"
        "for f in os.listdir(os.path.join(manifest.BENCH_DIR, 'metrics')):\n"
        "    manifest.reader(f[:-3])\n"
        "import benchmark.drivers.detect as d, benchmark.drivers.train as t\n"
        "import cascadeclassifier_tpu_torch.detect.detector\n"
        "import cascadeclassifier_tpu_torch.train.trainer\n"
        "from benchmark import guard\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "frontal_alt.video2160", "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "frontal_alt.video2160", "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
