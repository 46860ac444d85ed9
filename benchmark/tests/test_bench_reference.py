"""The benchmark's references against OpenCV's own outputs, on the CPU.

Detection: OpenCV 4.x's detectMultiScale rects (``golden_frontal_alt_
1080p.json``, made by OpenCV's C++ runtime on the synthetic frames 0 and
1) at minNeighbors 3 and 0. Training: the BASIC feature catalog against
opencv_traincascade's own dump, and the reference's judge of a cascade
the program trains at a toy size.
"""

import gzip
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.generate import synth_scene
from benchmark.reference.cascade import exact_f64_sums, read_cascade
from benchmark.reference.detect import ReferenceDetector, clip_rects, sort_rects
from benchmark.reference.group import group_rectangles
from benchmark.reference.train import haar_basic

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "golden_frontal_alt_1080p.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def frontal():
    return read_cascade(os.path.join(BENCH, "configs", "haarcascade_frontalface_alt.xml"))


def test_cascade_reads_whole(frontal):
    assert (frontal.win_w, frontal.win_h) == (20, 20)
    assert len(frontal.stages) == 22 and frontal.n_trees == 2135
    assert exact_f64_sums(frontal)


@pytest.mark.parametrize("k", [0, 1])
def test_detection_reference_equals_opencv(golden, frontal, k):
    fr = golden["frames"][k]
    img = synth_scene(3 + fr["k"], golden["height"], golden["width"])
    assert hashlib.sha256(img.tobytes()).hexdigest() == fr["sha256"]
    torch.set_num_threads(min(4, torch.get_num_threads()))
    raw = ReferenceDetector(frontal, "cpu").raw_batch([img], golden["scale_factor"])[0]
    h, w = img.shape
    mn0 = sort_rects(clip_rects(raw, w, h))
    mn3 = sort_rects(clip_rects(group_rectangles(raw, 3), w, h))
    np.testing.assert_array_equal(mn0, sort_rects(np.array(fr["rects_mn0"])))
    np.testing.assert_array_equal(mn3, sort_rects(np.array(fr["rects_mn3"])))


def test_group_rectangles_by_hand():
    near = [(100, 100, 40, 40), (102, 101, 40, 40), (98, 99, 41, 41), (101, 100, 40, 40)]
    far = [(300, 300, 40, 40)]
    out = group_rectangles(near + far, 3)
    # one class of 4 (averages 100.25, 100, 40.25, 40.25 round half even),
    # the lone rect dropped
    np.testing.assert_array_equal(out, [[100, 100, 40, 40]])
    assert len(group_rectangles(near + far, 0)) == 5


def test_basic_catalog_equals_traincascade():
    path = os.path.join(ROOT, "tests", "golden", "geom_haar_12x10_BASIC.txt.gz")
    if not os.path.exists(path):
        pytest.skip("opencv_traincascade's feature dump is not in this checkout")
    with gzip.open(path, "rt") as f:
        rows = [line.split() for line in f][1:]
    want = np.array([[int(float(v)) for v in r[2:]] for r in rows])
    r, w = haar_basic(12, 10)
    got = np.concatenate([np.concatenate([r[:, i], w[:, i:i + 1].astype(np.int64)], 1)
                          for i in range(3)], 1)
    np.testing.assert_array_equal(got, want)
    assert len(haar_basic(24, 24)[0]) == 162336
