"""The tilted-feature reference (``reference/detect_tilted.py``) against
OpenCV's own outputs, on the CPU.

OpenCV 4.x's detectMultiScale rects for ``haarcascade_upperbody.xml``
(``golden_upperbody_1080p.json``, made by OpenCV's C++ runtime on the
synthetic frames 0 and 1) at minNeighbors 3 and 0; the reader over the
whole upper body; the tilted integral against its definition; and the
reference against ``reference/detect.py`` on an upright cascade.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.generate import synth_scene
from benchmark.reference import detect, detect_tilted
from benchmark.reference.cascade import exact_f64_sums, read_cascade
from benchmark.reference.detect import clip_rects, sort_rects
from benchmark.reference.group import group_rectangles

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "golden_upperbody_1080p.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def upperbody():
    return detect_tilted.read_cascade(os.path.join(CONFIGS, "haarcascade_upperbody.xml"))


def test_reader_reads_the_upper_body_whole(upperbody):
    c = upperbody
    assert (c.win_w, c.win_h) == (22, 18)
    assert len(c.stages) == 30 and c.n_trees == 2423
    used = np.concatenate([s.feature for s in c.stages])
    assert len(c.rects) == 2423 and int(c.tilted[used].sum()) == 474
    assert exact_f64_sums(c)


@pytest.mark.parametrize("k", [0, 1])
def test_tilted_reference_equals_opencv(golden, upperbody, k):
    fr = golden["frames"][k]
    img = synth_scene(3 + fr["k"], golden["height"], golden["width"])
    assert hashlib.sha256(img.tobytes()).hexdigest() == fr["sha256"]
    torch.set_num_threads(min(4, torch.get_num_threads()))
    ref = detect_tilted.ReferenceDetector(upperbody, "cpu")
    raw = ref.raw_batch([img], golden["scale_factor"])[0]
    h, w = img.shape
    mn0 = sort_rects(clip_rects(raw, w, h))
    mn3 = sort_rects(clip_rects(group_rectangles(raw, 3), w, h))
    np.testing.assert_array_equal(mn0, sort_rects(np.array(fr["rects_mn0"])))
    np.testing.assert_array_equal(mn3, sort_rects(np.array(fr["rects_mn3"])))


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (4, 9), (17, 12)])
def test_tilted_integral_is_its_definition(shape):
    h, w = shape
    px = torch.as_tensor(np.random.default_rng(h * 31 + w).integers(0, 256, (h, w)))
    want = np.zeros((h + 1, w + 1), np.int64)
    p = px.numpy()
    for yy in range(h + 1):
        for xx in range(w + 1):
            want[yy, xx] = sum(int(p[y, x]) for y in range(yy) for x in range(w)
                               if abs(x - xx + 1) <= yy - y - 1)
    np.testing.assert_array_equal(detect_tilted.tilted_integral(px).numpy(), want)


def test_upright_cascade_matches_the_upright_reference(golden):
    path = os.path.join(CONFIGS, "haarcascade_frontalface_alt.xml")
    img = synth_scene(3 + golden["frames"][0]["k"], golden["height"], golden["width"])
    torch.set_num_threads(min(4, torch.get_num_threads()))
    a = detect.ReferenceDetector(read_cascade(path), "cpu").raw_batch([img])[0]
    c = detect_tilted.read_cascade(path)
    assert not c.tilted.any()
    b = detect_tilted.ReferenceDetector(c, "cpu").raw_batch([img])[0]
    assert len(a) > 0
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(group_rectangles(a, 3), group_rectangles(b, 3))
