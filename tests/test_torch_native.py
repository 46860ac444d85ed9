"""The port's host library (csrc/cctpu_io.cpp through data/native.py):
grouping, the .vec codec and the negative-window miner, each held byte
for byte against the JAX package and the port's numpy paths; and the
order in which the detector hands its rects to grouping (the plain
stack's, whatever the plan's layout)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cascadeclassifier_tpu.data.negreader import NegReader as JNegReader  # noqa: E402
from cascadeclassifier_tpu.detect import grouping as jgrouping  # noqa: E402
from cascadeclassifier_tpu.detect.detector import TPUDetector  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml as jread_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.data import native  # noqa: E402
from cascadeclassifier_tpu_torch.data.negreader import NegReader  # noqa: E402
from cascadeclassifier_tpu_torch.data.vec import read_vec, write_vec  # noqa: E402
from cascadeclassifier_tpu_torch.detect import grouping  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    TorchDetector,
    _stack_rects,
    positions_to_rects,
)
from cascadeclassifier_tpu_torch.detect.pyramid import build_plan  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.utils.time_grouping import detection_like  # noqa: E402
from cascadeclassifier_tpu_torch.utils.train_data import (  # noqa: E402
    background,
    write_pgm,
    write_png,
)

from .utils_synth import face_blob_image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTAL = os.path.join(REPO, "cascadeclassifier_tpu_torch", "data",
                       "haarcascade_frontalface_alt.xml")
NM = grouping.NATIVE_MAX


def _pyramid_like(n: int, seed: int) -> np.ndarray:
    """test_torch_hog.py's raw windows of a pyramid: 25 sizes 1.1 apart,
    positions on each level's grid, duplicates, clusters across sizes."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, 25, n)
    f = 1.1 ** lv
    size = np.rint(24 * f).astype(np.int64)
    step = np.where(f < 2, 2, 1)
    cx, cy = rng.integers(0, max(2, n // 130), n), rng.integers(0, max(2, n // 200), n)
    x = np.rint((cx * 6 + rng.integers(0, 3, n) * step) * f).astype(np.int64)
    y = np.rint((cy * 6 + rng.integers(0, 3, n) * step) * f).astype(np.int64)
    rects = np.stack([x, y, size, size + (lv % 3 == 0)], axis=1)
    k = n // 10
    rects[:k] = rects[k:2 * k]  # exact duplicates
    return rects


def test_host_library_builds_under_the_port():
    """g++ builds csrc/cctpu_io.cpp into the port's _build/, which is
    where the loaded library comes from; the source includes only the
    C++ standard library."""
    path = native.get_lib()._name
    assert os.path.dirname(os.path.dirname(path)) == _build.BUILD_DIR
    assert os.path.basename(path) == _build.HOST_LIB_NAME
    with open(os.path.join(_build.CSRC_DIR, _build.HOST_SOURCE)) as f:
        includes = [ln.split()[1] for ln in f if ln.startswith("#include")]
    assert includes and all(h.startswith("<c") or h in (
        "<algorithm>", "<fstream>", "<string>", "<vector>") for h in includes), includes
    assert _build.build_host() == path  # the same sources reuse the build


@pytest.mark.parametrize("thr", [0, 1, 3])
@pytest.mark.parametrize("kind,n", [
    ("detection", NM - 1), ("detection", NM), ("detection", NM + 1),
    ("pyramid", NM - 1), ("pyramid", NM), ("pyramid", NM + 1),
])
def test_native_grouping_matches(kind, n, thr):
    """Around NATIVE_MAX: the library, the numpy path (both pair searches)
    and the dispatch give the JAX package's rects in its order."""
    rects = detection_like(n, seed=thr) if kind == "detection" else _pyramid_like(n, n + thr)
    want = jgrouping.group_rectangles(rects, thr)
    if thr > 0:
        assert 0 < len(want) < n
    for got in (native.group_rectangles_native(rects, thr),
                grouping.group_rectangles(rects, thr),
                grouping.group_numpy(rects, thr),
                grouping.group_numpy(rects, thr, pairs=grouping.dense_pairs),
                grouping.group_numpy(rects, thr, pairs=grouping.kd_pairs)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_grouping_dispatch():
    """group_rectangles takes the library up to NATIVE_MAX rects and the
    numpy path beyond; a threshold <= 0 or no rects return the input."""
    calls = []
    lib = native.get_lib()
    real = lib.cctpu_group_rectangles

    class Spy:
        def __call__(self, *args):
            calls.append(args[1])
            return real(*args)

    rects = detection_like(NM + 1)
    try:
        lib.cctpu_group_rectangles = Spy()
        grouping.group_rectangles(rects[:NM], 3)
        grouping.group_rectangles(rects, 3)
    finally:
        lib.cctpu_group_rectangles = real
    assert calls == [NM]
    for group in (native.group_rectangles_native, grouping.group_rectangles,
                  grouping.group_numpy):
        np.testing.assert_array_equal(group(rects[:5], 0), rects[:5])
        assert group(np.zeros((0, 4), np.int64), 2).shape == (0, 4)


@pytest.mark.parametrize("group", [grouping.group_rectangles, grouping.group_numpy],
                         ids=["auto", "ref"])
def test_grouping_clips_after_average(group):
    """tests/test_detector.py's case through each grouping
    (group_rectangles takes the host library at 4 rects, group_numpy is
    its plain version): a
    coarsest-level member overhanging the bottom edge takes part in the
    average with its unclipped height (h = 133), and the clip comes
    after; grouping the pre-clipped list gives h = 132."""
    members = np.array([(22, 333, 148, 148), (30, 333, 148, 148), (34, 343, 135, 135),
                        (51, 359, 101, 101)], np.int64)
    grouped = grouping.clip_rects(group(members, 2), 640, 480)
    assert grouped.shape == (1, 4)
    assert tuple(map(int, grouped[0])) == (34, 342, 133, 133)
    pre = members.copy()
    pre[:, 3] = np.minimum(pre[:, 3], 480 - pre[:, 1])
    assert int(group(pre, 2)[0][3]) == 132


@pytest.mark.parametrize("w,h,sf", [(320, 240, 1.2), (200, 150, 1.1)])
def test_plain_stack_index_order_is_stack_order(w, h, sf):
    """On the plain stack (levels stacked downwards, each at column 0),
    ascending canvas index is level, row, column: _stack_rects keeps the
    order there, and reorders the shelf-packed plan's into it."""
    plain = build_plan(w, h, 24, 24, sf, pack_band=False)
    assert (np.diff(plain.block_top) > 0).all() and (plain.block_left == 0).all()
    packed = build_plan(w, h, 24, 24, sf, pack_band=True)
    idx = {False: [], True: []}
    for s in range(len(plain.scales)):
        ys = np.arange(int(plain.scaled_h[s]) - 24 + 1)
        cs = np.arange(int(plain.scaled_w[s]) - 24 + 1)
        yy, cc = (a.ravel() for a in np.meshgrid(ys, cs, indexing="ij"))
        for pk, plan in ((False, plain), (True, packed)):
            idx[pk].append((plan.block_top[s] + yy) * plan.out_w + plan.block_left[s] + cc)
    flat = np.concatenate(idx[False])
    assert (np.diff(flat) > 0).all()
    want = positions_to_rects(plain, flat)
    np.testing.assert_array_equal(_stack_rects(plain, flat), want)
    shelf = np.sort(np.concatenate(idx[True]))
    assert not np.array_equal(positions_to_rects(packed, shelf), want)
    np.testing.assert_array_equal(_stack_rects(packed, shelf), want)


def test_detector_groups_unclipped_rects_in_stack_order():
    """TorchDetector.group on the shelf-packed plan equals clip_rects(
    group_rectangles(unclipped rects in the plain stack's order)), and
    the plain stack's group, in order. The windows: the bottom right
    corner of the coarsest level's grid, which overhangs the frame, and
    the bottom left corner of a finer level on the same shelf, whose rows
    come after the coarsest level's in canvas order and before them in
    the stack's."""
    w, h, sf = 320, 240, 1.2
    packed = build_plan(w, h, 24, 24, sf, pack_band=True)
    plain = build_plan(w, h, 24, 24, sf, pack_band=False)
    coarse = len(plain.scales) - 1
    fine = int(np.flatnonzero(packed.block_top == packed.block_top[coarse])[0])
    assert fine < coarse
    sel = {False: [], True: []}
    for s, right in ((fine, False), (coarse, True)):
        ym, cm = int(plain.scaled_h[s]) - 24, int(plain.scaled_w[s]) - 24
        yy, cc = (a.ravel() for a in np.meshgrid(
            [ym - 1, ym], [cm - 1, cm] if right else [0, 1], indexing="ij"))
        for pk, plan in ((False, plain), (True, packed)):
            sel[pk].append((plan.block_top[s] + yy) * plan.out_w + plan.block_left[s] + cc)
    idx_plain = np.concatenate(sel[False])
    idx_packed = np.sort(np.concatenate(sel[True]))
    unclipped = positions_to_rects(plain, idx_plain)
    assert (unclipped[:, 1] + unclipped[:, 3] > h).any()
    for thr in (1, 2, 3):
        want = grouping.clip_rects(grouping.group_rectangles(unclipped, thr), w, h)
        assert len(want) == 2 and want[0][2] < want[1][2]  # the finer level's first
        np.testing.assert_array_equal(TorchDetector.group(packed, idx_packed, thr), want)
        np.testing.assert_array_equal(TorchDetector.group(plain, idx_plain, thr), want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("engine", ["fused", "pallas", "auto"])
@pytest.mark.parametrize("seed", [2, 5])
def test_detector_rect_order_matches_original(seed, engine, exact):
    """The port's engines print the JAX TPUDetector(engine="fused")'s
    rects in its order at both exact values, on face-blob images (frontal
    face, sf 1.2, minNeighbors 1), whatever plan the engine takes."""
    img = face_blob_image(240, 180, n=4, seed=seed)
    want = TPUDetector(jread_cascade_xml(FRONTAL), engine="fused",
                       exact=exact).detect_multi_scale(img, 1.2, 1)
    det = TorchDetector(read_cascade_xml(FRONTAL), engine=engine, exact=exact, device="cpu")
    assert det.pack_band == (det.engine_name == "fused")
    got = det.detect_multi_scale(img, 1.2, 1)
    assert len(want) >= 3
    np.testing.assert_array_equal(got, np.asarray(want, np.int32).reshape(-1, 4))


def test_native_vec_round_trip(tmp_path):
    """native_write_vec writes data/vec.py's bytes; each reader reads the
    other's file (9 samples of 14 x 10, as tests/test_data.py)."""
    s = np.random.default_rng(0).integers(0, 256, (9, 14, 10)).astype(np.uint8)
    p_nat, p_py = str(tmp_path / "n.vec"), str(tmp_path / "p.vec")
    assert native.native_write_vec(p_nat, s)
    write_vec(p_py, s)
    assert open(p_nat, "rb").read() == open(p_py, "rb").read()
    np.testing.assert_array_equal(read_vec(p_nat, 10, 14), s)
    np.testing.assert_array_equal(native.native_read_vec(p_py).reshape(9, 14, 10), s)
    assert native.native_read_vec(str(tmp_path / "empty.vec")) is None  # missing
    assert native.native_write_vec(str(tmp_path / "absent" / "x.vec"), s) is False


def test_native_vec_unreadable(tmp_path):
    """A truncated header, or a header promising more records than the
    file holds, reads as None (data/vec.py raises VecError on both)."""
    good = str(tmp_path / "g.vec")
    write_vec(good, np.zeros((3, 4, 4), np.uint8))
    data = open(good, "rb").read()
    for name, body in (("header", data[:7]), ("body", data[:-1]),
                       ("huge", np.array([1 << 30, 16, 0], "<i4").tobytes()[:12])):
        p = str(tmp_path / f"{name}.vec")
        open(p, "wb").write(body)
        assert native.native_read_vec(p) is None, name
    zero = str(tmp_path / "zero.vec")
    write_vec(zero, np.zeros((0, 4, 4), np.uint8))
    assert native.native_read_vec(zero).shape == (0, 16)


def _backgrounds(tmp_path) -> str:
    """A bg list: PGM and PNG clutter frames (every PNG filter), one image
    smaller than a 24x24 window, one missing file, a comment."""
    rng = np.random.default_rng(1)
    names = ["# backgrounds"]
    for i, (h, w) in enumerate(((120, 160), (97, 131), (150, 90), (20, 30), (None, None),
                                (64, 300), (88, 88))):
        path = str(tmp_path / f"bg{i}.{'pgm' if i % 2 == 0 else 'png'}")
        if h is not None:
            img = (background(h, w, seed=i) if h > 40 else
                   rng.integers(0, 256, (h, w)).astype(np.uint8))
            (write_pgm if path.endswith(".pgm") else write_png)(path, img)
        names.append(path)
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n\nafter-the-empty-line.png\n")
    return bg


@pytest.mark.parametrize("ww,wh", [(24, 24), (20, 12)])
def test_native_neg_reader_matches(tmp_path, ww, wh):
    """NativeNegReader gives the port's NegReader's and the JAX
    NegReader's windows byte for byte over 1 000 windows (several rounds
    over the list, every scale step), taken in uneven batches."""
    bg = _backgrounds(tmp_path)
    want = NegReader(bg, ww, wh).take_batch(1000)
    jwant = JNegReader(bg, ww, wh).take_batch(1000)
    np.testing.assert_array_equal(want, jwant)
    reader = native.NativeNegReader(bg, ww, wh)
    got = np.concatenate([reader.take_batch(k) for k in (1, 2, 397, 600)])
    reader.close()
    assert got.shape == (1000, wh, ww)
    np.testing.assert_array_equal(got, want)


def test_native_neg_reader_error_paths(tmp_path):
    """A missing or empty list raises FileNotFoundError; a list of
    unreadable files yields nothing; an exception of the image reader
    reaches take_batch."""
    with pytest.raises(FileNotFoundError):
        native.NativeNegReader(str(tmp_path / "nope.txt"), 24, 24)
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").write("\n")
    with pytest.raises(FileNotFoundError):
        native.NativeNegReader(empty, 24, 24)
    bad = str(tmp_path / "bad.txt")
    open(bad, "w").write(str(tmp_path / "missing.png") + "\n")
    assert native.NativeNegReader(bad, 24, 24).take_batch(3).shape == (0, 24, 24)
    assert NegReader(bad, 24, 24).take_batch(3).shape == (0, 24, 24)

    def broken(path):
        raise ValueError(f"cannot decode {path}")

    reader = native.NativeNegReader(_backgrounds(tmp_path), 24, 24, imread=broken)
    with pytest.raises(ValueError, match="cannot decode"):
        reader.take_batch(5)


def _object_png(tmp_path) -> str:
    """A 40x30 object (bright card, dark bars) on a background of 0."""
    rng = np.random.default_rng(2)
    img = np.zeros((30, 40), np.uint8)
    img[3:27, 4:36] = rng.integers(150, 256, (24, 32))
    img[8:22:4, 8:32] = 20
    path = str(tmp_path / "obj.png")
    write_png(path, img)
    return path


@pytest.mark.parametrize("usable", [True, False])
def test_createsamples_backgrounds_match_original(tmp_path, usable):
    """createsamples -img -bg takes its windows from the host library's
    miner and writes through its codec: the JAX function's .vec bytes
    over _backgrounds' list (a missing file, one too small), and over a
    list with no usable background (every sample on bgcolor)."""
    pytest.importorskip("cv2")
    from cascadeclassifier_tpu.tools import createsamples as jcs
    from cascadeclassifier_tpu_torch.tools.createsamples import create_training_samples

    img = _object_png(tmp_path)
    bg = _backgrounds(tmp_path)
    if not usable:
        bg = str(tmp_path / "unusable.txt")
        with open(bg, "w") as f:
            f.write(f"{tmp_path / 'bg3.pgm'}\n{tmp_path / 'bg4.png'}\n")  # 20x30, missing
    kw = dict(bg_path=bg, bgcolor=17, maxxangle=0.8, maxyangle=0.8, maxzangle=0.4, win_w=24,
              win_h=20, rngseed=5)
    assert create_training_samples(str(tmp_path / "port.vec"), img, 120, **kw) == 120
    jcs.create_training_samples(str(tmp_path / "jax.vec"), img, 120, **kw)
    assert (tmp_path / "port.vec").read_bytes() == (tmp_path / "jax.vec").read_bytes()
    samples = read_vec(str(tmp_path / "port.vec"), 24, 20)
    assert (samples[:, 0, 0] == 17).all() != usable


def test_show_vec_samples_matches_original(tmp_path):
    """createsamples -vec -show reads through the host library's codec:
    the JAX function's images (the squarest window guess), and a missing
    .vec raises VecError."""
    cv2 = pytest.importorskip("cv2")
    from cascadeclassifier_tpu.tools import createsamples as jcs
    from cascadeclassifier_tpu_torch.data.vec import VecError
    from cascadeclassifier_tpu_torch.tools.createsamples import show_vec_samples

    s = np.random.default_rng(3).integers(0, 256, (70, 12, 18)).astype(np.uint8)
    vec = str(tmp_path / "s.vec")
    write_vec(vec, s)
    assert show_vec_samples(vec, str(tmp_path / "port")) == 70
    assert jcs.show_vec_samples(vec, str(tmp_path / "jax")) == 70
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 64
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "jax" / name),
                                                      cv2.IMREAD_UNCHANGED))
        assert got.shape == (12, 18)
    with pytest.raises(VecError):
        show_vec_samples(str(tmp_path / "missing.vec"), str(tmp_path / "none"))
