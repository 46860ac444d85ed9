"""Survivor-packed front of the PyTorch port (kernel packed_front) and its
block list against the JAX package's ``live_block_list`` and its packed
band and plane Pallas fronts (interpret mode)."""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.compact import pad_canvas_for_patchify  # noqa: E402
from cascadeclassifier_tpu.detect.dense import dense_variance_gate  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    _build_canvas,
    _resize_matrices,
    plan_tables,
)
from cascadeclassifier_tpu.detect.pallas_front import (  # noqa: E402
    front_pad_geometry,
    make_packed_band_front_fn,
    make_packed_plane_front_fn,
    plane_pad_geometry,
)
from cascadeclassifier_tpu.detect.pallas_front import (  # noqa: E402
    live_block_list as jlive_block_list,
)
from cascadeclassifier_tpu.detect.pyramid import build_plan  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.convert import from_jax_packed  # noqa: E402
from cascadeclassifier_tpu_torch.detect.front import front_ref  # noqa: E402
from cascadeclassifier_tpu_torch.detect.packed_front import (  # noqa: E402
    BLK_H,
    BLK_W,
    block_grid,
    listed_tiles,
    listed_windows,
    live_block_list,
    packed_front,
    packed_front_ref,
)

from cascadeclassifier_tpu_torch.detect.records import TILE_H, TILE_W  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    PACKED_SHAPES,
    block_lists,
    edge_masks,
    packed_edge_mismatches,
)

HAAR_ALT = os.path.join(  # the port's vendored copy of OpenCV's file
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data", "haarcascade_frontalface_alt.xml",
)
STAGES = [1, 2, 3]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _jax_list(mask_np):
    """JAX's block list of a mask zero-padded to whole 16x512 blocks."""
    h, w = mask_np.shape
    nbr, nbc = block_grid(h, w)
    padded = np.zeros((nbr * BLK_H, nbc * BLK_W), np.int32)
    padded[:h, :w] = mask_np
    blk, nblk = jlive_block_list(jnp.asarray(padded), nbr * nbc)
    return np.asarray(blk), int(nblk)


def _mask(kind, rng):
    if kind == "empty":
        return np.zeros((64, 1024), bool)
    if kind == "full":
        return np.ones((48, 1536), bool)
    if kind == "ragged":  # partial edge blocks on both axes
        m = np.zeros((53, 1300), bool)
        m[rng.integers(0, 53, 9), rng.integers(0, 1300, 9)] = True
        m[52, 1299] = True
        return m
    m = np.zeros((96, 2048), bool)  # random: sparse points, some blocks dead
    m[rng.integers(0, 96, 12), rng.integers(0, 2048, 12)] = True
    return m


@pytest.mark.parametrize("kind", ["random", "empty", "full", "ragged"])
def test_live_block_list_matches_jax(kind):
    mask = _mask(kind, np.random.default_rng(4))
    blk, nblk = live_block_list(torch.from_numpy(mask))
    jblk, jnblk = _jax_list(mask)
    assert blk.dtype == nblk.dtype == torch.int32 and tuple(nblk.shape) == (1,)
    assert int(nblk[0]) == jnblk
    np.testing.assert_array_equal(blk.numpy(), jblk)
    if kind == "random":
        assert 0 < jnblk < len(jblk)


@pytest.fixture(scope="module")
def setup():
    """Random 160x120 frame, as tests/test_torch_front.py builds it: JAX
    canvas, gate and inv_nf, the port's cascade and its block list of the
    gate mask."""
    jpacked = JPackedCascade.from_model(read_cascade_xml(HAAR_ALT))
    rng = np.random.default_rng(5)
    w, h = 160, 120
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    plan = build_plan(w, h, 20, 20, 1.1, None, None)
    sum2d, sq2d, _ = _build_canvas(
        jnp.asarray(img), plan_tables(plan), w, h, need_sq=True,
        resize_mats=_resize_matrices(plan),
    )
    out_h, out_w = plan.canvas_h - 20, plan.canvas_w - 20
    gate, inv_nf = dense_variance_gate(sum2d, sq2d, 20, 20, out_h, out_w)
    t = dict(sum2d=torch.from_numpy(np.array(sum2d)), inv=torch.from_numpy(np.array(inv_nf)),
             gate=torch.from_numpy(np.array(gate)))
    blk, nblk = live_block_list(t["gate"])
    cas = from_jax_packed(jpacked)
    dense = front_ref(t["sum2d"], t["inv"], t["gate"], cas, STAGES[0], STAGES[-1] + 1)
    return dict(jpacked=jpacked, cas=cas, plan=plan, sum2d=sum2d, gate=gate, inv_nf=inv_nf,
                out_h=out_h, out_w=out_w, t=t, blk=blk, nblk=nblk, dense=dense.numpy())


def _twin(s, blk, nblk):
    t = s["t"]
    return packed_front_ref(t["sum2d"], t["inv"], t["gate"], blk, nblk, s["cas"],
                            STAGES[0], STAGES[-1] + 1).numpy()


def test_twin_on_a_full_list_equals_front_ref(setup):
    s = setup
    got = _twin(s, s["blk"], s["nblk"])
    assert int(s["nblk"][0]) == len(s["blk"])  # the gate touches every block
    assert s["dense"].sum() > 1000  # non-vacuous
    np.testing.assert_array_equal(got, s["dense"])


def test_twin_on_a_short_list_keeps_omitted_blocks(setup):
    s = setup
    gate = s["t"]["gate"].numpy()
    k = int(s["nblk"][0]) // 2
    got = _twin(s, s["blk"], torch.tensor([k], dtype=torch.int32))
    inside = listed_windows(s["blk"], torch.tensor([k], dtype=torch.int32),
                            s["out_h"], s["out_w"]).numpy()
    assert 0 < inside.sum() < inside.size
    np.testing.assert_array_equal(got[inside], s["dense"][inside])
    np.testing.assert_array_equal(got[~inside], gate[~inside])
    assert (gate[~inside] & ~s["dense"][~inside]).any()  # would have died


@pytest.mark.parametrize("cut", [None, 3])
def test_twin_matches_packed_band_front_kernel(setup, cut):
    """make_packed_band_front_fn over the band rows [row_lo, out_h) with
    JAX's own block list (cut to `cut` blocks) against the twin with the
    same blocks in canvas coordinates."""
    s = setup
    jp, plan, out_h, out_w = s["jpacked"], s["plan"], s["out_h"], s["out_w"]
    split_r = int(plan.block_top[np.nonzero(plan.ystep == 1)[0][0]])
    row_lo = (split_r // BLK_H) * BLK_H
    hp, wp, hh, hw = front_pad_geometry(plan.canvas_h, plan.canvas_w, 20, 20, 128, 512)
    nb_cap = ((hp - row_lo) // BLK_H) * (wp // BLK_W)
    fn, _ = make_packed_band_front_fn(
        jp.stages, STAGES, 20, 20, plan.canvas_h, plan.canvas_w, nb_cap, 128, 512,
        interpret=True, row_lo=row_lo,
    )
    sum_pad = pad_canvas_for_patchify(s["sum2d"], 20, hp + hh, wp + hw)
    inv_b = np.ones((hp - row_lo, wp), np.float32)
    inv_b[: out_h - row_lo, :out_w] = np.asarray(s["inv_nf"])[row_lo:]
    gate = np.asarray(s["gate"])
    alive_b = np.zeros((hp - row_lo, wp), np.int32)
    alive_b[: out_h - row_lo, :out_w] = gate[row_lo:]
    jblk, jnblk = jlive_block_list(jnp.asarray(alive_b), nb_cap)
    n = int(jnblk) if cut is None else cut
    got = np.asarray(fn(sum_pad, jnp.asarray(inv_b), jnp.asarray(alive_b), jblk,
                        jnp.asarray([n], jnp.int32)))
    want = got[: out_h - row_lo, :out_w] != 0
    blk = torch.from_numpy(np.asarray(jblk) + np.array([row_lo // BLK_H, 0], np.int32))
    port = _twin(s, blk, torch.tensor([n], dtype=torch.int32))
    np.testing.assert_array_equal(port[row_lo:], want)
    np.testing.assert_array_equal(port[:row_lo], gate[:row_lo])  # never listed
    assert want.sum() > 100  # non-vacuous
    if cut is not None:
        kept = ~listed_windows(blk, torch.tensor([n], dtype=torch.int32), out_h, out_w)
        assert (port[kept.numpy()] & ~s["dense"][kept.numpy()]).any()


@pytest.mark.parametrize("cut", [None, 1])
def test_twin_matches_packed_plane_front_kernel_on_even_anchors(setup, cut):
    """make_packed_plane_front_fn over the (even, even) anchors above
    split_r, mapped back to the canvas: equal to the twin's mask there
    inside the listed plane blocks, the input elsewhere."""
    s = setup
    jp, plan, out_w = s["jpacked"], s["plan"], s["out_w"]
    split_r = int(plan.block_top[np.nonzero(plan.ystep == 1)[0][0]])
    hp2, wp2, hh2, hw2 = plane_pad_geometry(split_r, out_w, 20, 20, 128, 512)
    nb_cap = (hp2 // BLK_H) * (wp2 // BLK_W)
    fn, _ = make_packed_plane_front_fn(
        jp.stages, STAGES, 20, 20, split_r, out_w, nb_cap, 128, 512, interpret=True
    )
    ph, pw = hp2 + hh2, wp2 + hw2
    canvas = np.zeros((2 * ph, 2 * pw), np.int32)
    src = np.asarray(s["sum2d"])[: 2 * ph, : 2 * pw]
    canvas[: src.shape[0], : src.shape[1]] = src
    planes = jnp.asarray(
        np.stack([np.stack([canvas[a::2, b::2] for b in (0, 1)]) for a in (0, 1)])
    )
    rows2, cols2 = (split_r + 1) // 2, (out_w + 1) // 2
    gate = np.asarray(s["gate"])[0:split_r:2, 0::2]
    alive_p = np.zeros((hp2, wp2), np.int32)
    inv_p = np.ones((hp2, wp2), np.float32)
    alive_p[:rows2, :cols2] = gate
    inv_p[:rows2, :cols2] = np.asarray(s["inv_nf"])[0:split_r:2, 0::2]
    jblk, jnblk = jlive_block_list(jnp.asarray(alive_p), nb_cap)
    n = int(jnblk) if cut is None else cut
    assert n < int(jnblk) or cut is None
    got = np.asarray(fn(planes, jnp.asarray(inv_p), jnp.asarray(alive_p), jblk,
                        jnp.asarray([n], jnp.int32)))[:rows2, :cols2] != 0
    on_plane = np.zeros((hp2, wp2), bool)
    for bi, bj in np.asarray(jblk)[:n]:
        on_plane[bi * BLK_H : (bi + 1) * BLK_H, bj * BLK_W : (bj + 1) * BLK_W] = True
    on_plane = on_plane[:rows2, :cols2]
    port = _twin(s, s["blk"], s["nblk"])[0:split_r:2, 0::2]
    assert got.sum() > 100  # non-vacuous
    np.testing.assert_array_equal(got[on_plane], port[on_plane])
    np.testing.assert_array_equal(got[~on_plane], gate[~on_plane])
    if cut is not None:
        assert (~on_plane).any() and (gate[~on_plane] & ~port[~on_plane]).any()


@pytest.mark.parametrize("out_h,out_w", PACKED_SHAPES + ((53, 1300),))
def test_listed_tiles_cover_each_listed_window_once(out_h, out_w):
    """The kernel's grid over a list (``listed_tiles``): every window of a
    listed block lies in exactly one tile and no window of an unlisted
    block in any, for every list of utils/edges.py (cut short, empty,
    entries outside the block grid, reverse order), at edge blocks and
    where the grid is one column wider than a block."""
    masks = edge_masks(out_h, out_w, "cpu")
    for name in ("all alive", "last window"):
        for lname, (blk, nblk) in block_lists(masks[name]).items():
            tiles = listed_tiles(blk.numpy(), int(nblk[0]), out_h, out_w)
            hits = np.zeros((out_h, out_w), np.int32)
            for r0, c0, th, tw in tiles:
                assert r0 % BLK_H == 0 and c0 % TILE_W == 0
                assert 0 < th <= TILE_H and 0 < tw <= TILE_W
                hits[r0 : r0 + th, c0 : c0 + tw] += 1
            listed = listed_windows(blk, nblk, out_h, out_w).numpy()
            np.testing.assert_array_equal(hits, listed.astype(np.int32), err_msg=lname)
            if lname == "every block":
                assert listed.all()
                assert len(tiles) == (-(-out_h // TILE_H)) * (-(-out_w // TILE_W))
            if lname == "nblk 0":
                assert not tiles
    # the last window's block alone: its tiles right of the grid do not exist
    blk, nblk = block_lists(masks["last window"])["live blocks"]
    assert int(nblk[0]) == 1
    tiles = listed_tiles(blk.numpy(), 1, out_h, out_w)
    assert len(tiles) == -(-(out_w - (out_w - 1) // BLK_W * BLK_W) // TILE_W)


def test_twin_on_the_edge_lists_keeps_unlisted_windows(setup):
    """The twin over utils/edges.py's lists on the 160x120 frame's gate:
    listed windows get the dense front's value, the others keep theirs."""
    s = setup
    gate = s["t"]["gate"]
    for lname, (blk, nblk) in block_lists(gate).items():
        got = _twin(s, blk, nblk)
        inside = listed_windows(blk, nblk, s["out_h"], s["out_w"]).numpy()
        np.testing.assert_array_equal(got[inside], s["dense"][inside], err_msg=lname)
        np.testing.assert_array_equal(got[~inside], gate.numpy()[~inside], err_msg=lname)
        assert inside.all() == (lname not in ("cut short", "nblk 0")), lname


@pytest.mark.cuda
def test_kernel_matches_twin_and_front_on_the_edge_lists_on_card(setup, cuda_device):
    """Four window grids (the last one column wider than a listed block) x
    four masks x six block lists x stages [1, 8) and [4, 4)."""
    n, survivors, bad = packed_edge_mismatches(setup["cas"], cuda_device)
    torch.cuda.synchronize()
    assert not bad, bad
    assert n == 192 and survivors > 0


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(setup, cuda_device):
    s = setup
    t = {k: v.to(cuda_device) for k, v in s["t"].items()}
    args = (t["sum2d"], t["inv"], t["gate"])
    blk, nblk = live_block_list(t["gate"])
    assert torch.equal(blk.cpu(), s["blk"]) and torch.equal(nblk.cpu(), s["nblk"])
    for n in (int(s["nblk"][0]), 2):
        cut = torch.tensor([n], dtype=torch.int32, device=cuda_device)
        got = packed_front(*args, blk, cut, s["cas"], 1, 8)
        want = packed_front(*args, blk, cut, s["cas"], 1, 8, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
