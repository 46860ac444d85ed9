"""The port's detector against the benchmark's tilted-feature reference
(``benchmark/reference/detect_tilted.py``, plain PyTorch written from
OpenCV's runtime, no code of the port) on the CPU.

Seeded random stump cascades with a 22x18 window, about a third of
their features 45° tilted, are written as modern-format XML and read by
both readers; on seeded noise frames the port (``TorchDetector``,
engine auto: the stage engine with the tilted canvas, f64 sums) gives
the reference's raw windows and grouped rects exactly. Each seed yields
raw windows and evaluates tilted trees, so no case is vacuous.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.reference.detect import Counts, clip_rects, sort_rects  # noqa: E402
from benchmark.reference.detect_tilted import ReferenceDetector, read_cascade  # noqa: E402
from benchmark.reference.group import group_rectangles  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    TorchDetector,
    positions_to_rects,
)
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402

WIN_W, WIN_H = 22, 18
SCALE = 1.2


def _feature(rng, tilted: bool):
    """(rects, tilted) of one feature: a rect weighted −1 and one or two
    sub-rects weighted so the weighted areas cancel, every corner inside
    the window (tilted: x − h ≥ 0, x + w ≤ W, y + w + h ≤ H)."""
    while True:
        w, h = (int(v) for v in rng.integers(2, 9, 2))
        if tilted:
            if w + h > WIN_H or h + w > WIN_W:
                continue
            x = int(rng.integers(h, WIN_W - w + 1))
            y = int(rng.integers(0, WIN_H - w - h + 1))
        else:
            x = int(rng.integers(0, WIN_W - w + 1))
            y = int(rng.integers(0, WIN_H - h + 1))
        break
    rects = [(x, y, w, h, -1.0)]
    if rng.integers(0, 2) or w < 4:  # two rects: the first's first half, weight w / half
        hw = w // 2
        rects.append((x, y, hw, h, w / hw))
    else:  # three rects: the outer quarters of the first, weight 2 each
        q = w // 4
        rects.append((x, y, q, h, 2.0))
        rects.append((x + w - q, y + w - q, q, h, 2.0) if tilted else (x + w - q, y, q, h, 2.0))
    return rects, tilted


def random_cascade(seed: int):
    """(stages, features) of a seeded 3-stage cascade of 4–8 stumps a
    stage, about a third of its features tilted (stage 0's first one
    always); each stage's threshold lies midway between its least and
    greatest leaf sums."""
    rng = np.random.default_rng(seed)
    feats, stages = [], []
    for si in range(3):
        trees = []
        for t in range(int(rng.integers(4, 9))):
            tilted = (si == 0 and t == 0) or bool(rng.random() < 1 / 3)
            feats.append(_feature(rng, tilted))
            thr = np.float32(rng.uniform(-0.02, 0.02))
            left = np.float32(rng.uniform(0.2, 1.0)) * (1 if rng.random() < 0.5 else -1)
            right = np.float32(rng.uniform(0.2, 1.0)) * (1 if left < 0 else -1)
            trees.append((len(feats) - 1, float(thr), float(left), float(right)))
        lo = sum(min(a, b) for _, _, a, b in trees)
        hi = sum(max(a, b) for _, _, a, b in trees)
        stages.append((float(np.float32(lo + 0.45 * (hi - lo))), trees))
    return stages, feats


def write_xml(path, stages, feats):
    out = ['<?xml version="1.0"?>', "<opencv_storage>",
           '<cascade type_id="opencv-cascade-classifier">',
           "<stageType>BOOST</stageType>", "<featureType>HAAR</featureType>",
           f"<height>{WIN_H}</height>", f"<width>{WIN_W}</width>",
           "<featureParams><maxCatCount>0</maxCatCount></featureParams>",
           f"<stageNum>{len(stages)}</stageNum>", "<stages>"]
    for thr, trees in stages:
        out += ["<_>", f"<maxWeakCount>{len(trees)}</maxWeakCount>",
                f"<stageThreshold>{thr:.9e}</stageThreshold>", "<weakClassifiers>"]
        for f, t, a, b in trees:
            out.append(f"<_><internalNodes>0 -1 {f} {t:.9e}</internalNodes>"
                       f"<leafValues>{a:.9e} {b:.9e}</leafValues></_>")
        out += ["</weakClassifiers>", "</_>"]
    out += ["</stages>", "<features>"]
    for rects, tilted in feats:
        rs = "".join(f"<_>{x} {y} {w} {h} {wt!r}</_>" for x, y, w, h, wt in rects)
        out.append(f"<_><rects>{rs}</rects><tilted>{int(tilted)}</tilted></_>")
    out += ["</features>", "</cascade>", "</opencv_storage>"]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def noise_frame(seed: int, h: int = 120, w: int = 160) -> np.ndarray:
    return np.random.default_rng(seed + 1000).integers(0, 256, (h, w), dtype=np.uint8)


@pytest.mark.parametrize("seed", range(5))
def test_port_equals_tilted_reference(seed, tmp_path):
    torch.set_num_threads(1)
    path = str(tmp_path / "cascade.xml")
    stages, feats = random_cascade(seed)
    write_xml(path, stages, feats)
    img = noise_frame(seed)
    h, w = img.shape

    ref_c = read_cascade(path)
    counts = Counts(len(ref_c.stages))
    want = ReferenceDetector(ref_c, "cpu").raw_batch([img], SCALE, counts)[0]
    tilted_stages = [si for si, s in enumerate(ref_c.stages) if ref_c.tilted[s.feature].any()]
    assert len(want) > 0
    assert any(counts.stage_windows[si] > 0 for si in tilted_stages)

    det = TorchDetector(read_cascade_xml(path), device="cpu")
    assert det.engine_name == "pallas" and det.packed.has_tilted
    plan, idx = det.raw_windows(img, SCALE)
    np.testing.assert_array_equal(sort_rects(positions_to_rects(plan, idx)), want)
    for mn in (0, 3):
        np.testing.assert_array_equal(
            sort_rects(det.group(plan, idx, mn)),
            sort_rects(clip_rects(group_rectangles(want, mn), w, h)))
