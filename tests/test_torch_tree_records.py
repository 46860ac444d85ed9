"""Packed tree records and window tiles of the PyTorch port's front and
stage kernels (``detect/records.py``): the encoding round trip, the
corner offsets' range, a stage evaluated from the records tile by tile
against ``dense.stage_pass`` (bitwise), and the tile cover."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from cascadeclassifier_tpu_torch.detect import records  # noqa: E402
from cascadeclassifier_tpu_torch.detect.dense import stage_pass  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import PackedCascade  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data",
)
CASCADES = ["haarcascade_frontalface_alt.xml", "haarcascade_upperbody.xml"]
FIELDS = ("feat_rects", "weights", "tilted", "thr", "left_leaf", "right_leaf")
TILE_H, TILE_W = records.TILE_H, records.TILE_W


@pytest.fixture(scope="module")
def cascades():
    return {n: PackedCascade.from_model(read_cascade_xml(os.path.join(DATA, n)))
            for n in CASCADES}


def _canvases(seed, out_h, out_w, win_w, win_h):
    """A seeded integral canvas, a tilted canvas of arbitrary int32 values
    (so that corner sums wrap and come out negative too) and a positive
    inv_nf, as numpy."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (out_h + win_h, out_w + win_w)).astype(np.int64)
    sum2d = (px.cumsum(0).cumsum(1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    tilt2d = rng.integers(-(1 << 31), 1 << 31, sum2d.shape).astype(np.int32)
    inv_nf = rng.uniform(1e-4, 2e-2, (out_h, out_w)).astype(np.float32)
    return sum2d, tilt2d, inv_nf


@pytest.mark.parametrize("name", CASCADES)
def test_records_decode_back_to_the_packed_cascade(cascades, name):
    cas = cascades[name]
    rec = records.tree_records(cas.stages, cas.win_w, cas.win_h)
    assert rec.dtype.itemsize == 48 and len(rec) == sum(st.ntrees for st in cas.stages)
    got = records.decode_records(rec, cas.win_w, cas.win_h)
    for f in FIELDS:
        want = np.concatenate([getattr(st, f) for st in cas.stages])
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    assert got["tilted"].any() == cas.has_tilted


@pytest.mark.parametrize("name", CASCADES)
def test_every_corner_of_every_window_lies_inside_its_patch(cascades, name):
    """Window (row, col) of a tile reads cell row * pitch + col + corner:
    inside rows [0, TILE_H + win_h) and columns [0, TILE_W + win_w) of the
    integral patch, or of the tilted patch behind it for a tilted tree."""
    cas = cascades[name]
    pitch = records.tile_pitch(cas.win_w)
    bias = records.tilt_bias(cas.win_w, cas.win_h)
    assert TILE_W + cas.win_w <= pitch and bias == (TILE_H + cas.win_h) * pitch
    rec = records.tree_records(cas.stages, cas.win_w, cas.win_h)
    used = rec["weight"] != 0
    corner = rec["corner"].astype(np.int64)[used]  # (n rects, 4)
    tilted = np.repeat(np.concatenate([st.tilted for st in cas.stages])[:, None], 3, 1)[used]
    for row, col in ((0, 0), (TILE_H - 1, 0), (0, TILE_W - 1), (TILE_H - 1, TILE_W - 1)):
        cell = row * pitch + col + corner - bias * tilted[:, None]
        assert (cell >= 0).all() and (cell < bias).all()
        assert (cell // pitch < TILE_H + cas.win_h).all()
        assert (cell % pitch < TILE_W + cas.win_w).all()
        # and it is the cell the rect geometry names
        assert (cell // pitch >= row).all() and (cell % pitch >= col).all()
    assert int(rec["corner"].max()) < 1 << 16
    assert not rec["corner"][~used].any()


@pytest.mark.parametrize("name,si,kind", [
    ("haarcascade_frontalface_alt.xml", 1, "upright"),
    ("haarcascade_frontalface_alt.xml", 2, "mixed"),
    ("haarcascade_upperbody.xml", 0, "tilted"),
    ("haarcascade_upperbody.xml", 2, "tilted"),
])
def test_stage_from_records_equals_dense_stage_pass(cascades, name, si, kind):
    """Two tile rows and two tile columns, the last of each partial."""
    cas = cascades[name]
    st = cas.stages[si]
    k = (st.weights != 0).sum(axis=1)
    if kind == "tilted":
        assert st.tilted.any() and not st.tilted.all()
    else:
        assert not st.tilted.any()
    if kind != "upright":
        assert (k == 2).any() and (k == 3).any()
    out_h, out_w = TILE_H + 5, TILE_W + 9
    sum2d, tilt2d, inv_nf = _canvases(11 + si, out_h, out_w, cas.win_w, cas.win_h)
    rec = records.tree_records([st], cas.win_w, cas.win_h)
    t = {k: torch.from_numpy(v) for k, v in dict(s=sum2d, t=tilt2d, i=inv_nf).items()}
    want = stage_pass(t["s"], st, out_h, out_w, t["i"], t["t"]).numpy()
    got = records.records_stage_pass(
        rec, st.threshold, sum2d, tilt2d if cas.has_tilted else None, inv_nf,
        cas.win_w, cas.win_h)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()  # non-vacuous


def test_stage_from_records_skips_unweighted_rects_in_any_slot(cascades):
    """A weight-0 rect in the middle slot is dropped by the encoding, as
    dense.stage_pass drops it, and a tree with one weighted rect works."""
    cas = cascades["haarcascade_frontalface_alt.xml"]
    st = cas.stages[2]
    w = st.weights.copy()
    three = np.nonzero((w != 0).all(axis=1))[0]
    w[three[0], 1] = 0  # rects 0 and 2 remain
    w[three[1], 1:] = 0  # rect 0 alone
    st = dataclasses.replace(st, weights=w)
    out_h, out_w = 7, 40
    sum2d, _, inv_nf = _canvases(3, out_h, out_w, cas.win_w, cas.win_h)
    rec = records.tree_records([st], cas.win_w, cas.win_h)
    assert (rec["weight"][three[0]] != 0).tolist() == [True, True, False]
    assert (rec["weight"][three[1]] != 0).tolist() == [True, False, False]
    want = stage_pass(torch.from_numpy(sum2d), st, out_h, out_w,
                      torch.from_numpy(inv_nf)).numpy()
    got = records.records_stage_pass(rec, st.threshold, sum2d, None, inv_nf,
                                     cas.win_w, cas.win_h)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("out_h,out_w", [
    (2 * TILE_H - 1, 2 * TILE_W - 1),
    (2 * TILE_H, 2 * TILE_W),
    (2 * TILE_H + 1, 2 * TILE_W + 1),
    (1, 1),
])
def test_tile_cover_assigns_each_window_to_one_tile(out_h, out_w):
    hits = np.zeros((out_h, out_w), np.int32)
    for r0, c0, th, tw in records.tile_cover(out_h, out_w):
        assert r0 % TILE_H == 0 and c0 % TILE_W == 0
        assert 0 < th <= TILE_H and 0 < tw <= TILE_W
        hits[r0 : r0 + th, c0 : c0 + tw] += 1
    assert (hits == 1).all()
    assert len(records.tile_cover(out_h, out_w)) == (-(-out_h // TILE_H)) * (-(-out_w // TILE_W))


def test_device_table_holds_the_records(cascades):
    cas = cascades["haarcascade_upperbody.xml"]
    tab = cas.device_table("cpu")
    rec = records.tree_records(cas.stages, cas.win_w, cas.win_h)
    assert tab["records"].dtype == torch.uint8 and tab["records"].is_contiguous()
    assert tuple(tab["records"].shape) == (len(rec), 48)
    assert tab["records"].numpy().tobytes() == rec.tobytes()
    assert tab["pitch"] == records.tile_pitch(cas.win_w) and tab["has_tilted"]
    assert int(tab["stage_start"][-1]) == len(rec)


def test_tile_pitch_takes_the_least_pitch_and_refuses_wide_windows():
    assert records.tile_pitch(20) == records.tile_pitch(24) == 152
    assert records.tile_pitch(25) == records.tile_pitch(72) == 200
    assert records.tile_pitch(73) == records.tile_pitch(136) == 264
    assert all(p % 32 in (8, 24) for p in records.PITCHES)
    with pytest.raises(ValueError):
        records.tile_pitch(137)
