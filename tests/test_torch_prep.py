"""Prep kernel of the PyTorch port (kernel ``prep``, ``detect/prep.py``):
the wrapper's dispatch, the plain twin against the JAX package's prep
composed from its ``dense.py`` / ``engine.py`` pieces, the code plane
against the walk inputs it encodes, and a numpy replay of the kernel's
tiled walk against ``dense.parity_visited``. On the card, the kernel against the twin bit for
bit over cascade kinds, sum types, plans and frame sizes."""

import functools
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect import dense as jdense  # noqa: E402
from cascadeclassifier_tpu.detect import engine as jengine  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.detect.pyramid import build_plan as jbuild_plan  # noqa: E402
from cascadeclassifier_tpu.models.model import FEATURE_HAAR  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import (  # noqa: E402
    read_cascade_xml as jread_cascade_xml,
)
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.detect import dense  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    TorchDetector,
    build_pixel_canvas,
)
from cascadeclassifier_tpu_torch.detect.integral import integral  # noqa: E402
from cascadeclassifier_tpu_torch.detect.prep import (  # noqa: E402
    ON_GRID,
    RESET,
    prep,
    prep_ref,
    walk_code,
    walk_inputs,
)
from cascadeclassifier_tpu_torch.detect.pyramid import build_plan  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.utils.synth import synth_frame  # noqa: E402

DATA = os.path.join(  # the port's vendored copies of OpenCV's files
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data",
)
XMLS = {"alt": "haarcascade_frontalface_alt.xml", "alt2": "haarcascade_frontalface_alt2.xml",
        "lbp": "lbpcascade_frontalface.xml"}
TILE_W, WARP = 128, 32  # csrc/cascade_tile.cuh: kTileW; the lanes of a warp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _model(name):
    return read_cascade_xml(os.path.join(DATA, XMLS[name]))


def _frame(w, h, flat=False):
    """Synth frame 0 at w x h; flat: with two regions of one grey value,
    where nf² = 0 and the gate fails."""
    img = synth_frame(0, h, w).copy()
    if flat:
        img[: h // 3, : w // 2] = 77
        img[h // 2 :, w // 3 : (2 * w) // 3] = 200
    return img


def _prep_inputs(name, w, h, packed, exact=True, flat=False, device="cpu"):
    """(detector, plan, sum, sq, code) as the fused engine builds them."""
    det = TorchDetector(_model(name), exact=exact, device=device, engine="fused",
                        pack_band=packed)
    plan = det.plan_for(w, h, 1.1, None, None)
    levels, code = det.engine._plan_tensors(plan)
    img = torch.from_numpy(_frame(w, h, flat)).to(device)
    s, q = integral(build_pixel_canvas(img, plan, levels, torch.uint8))
    return det, plan, s, q, code


def _jax_prep(js, jq, jplan, jpacked, exact):
    """The JAX FusedEngine's prep composed from its pieces on the same
    canvases: the gate (none for LBP), stage 0 by its kind's dense pass and
    the threshold in the stage sums' type, then the walk; on a shelf-packed
    plan ystep-2 rows walk on the visit grid, band rows on grid2d with the
    gaps between levels resetting the walk. → (inv_nf or None, alive)."""
    oh, ow = jplan.canvas_h - jpacked.win_h, jplan.canvas_w - jpacked.win_w
    st0 = jpacked.stages[0]
    is_haar = jpacked.feature_type == FEATURE_HAAR
    if is_haar:
        gate, inv = jdense.dense_variance_gate(js, jq, jpacked.win_w, jpacked.win_h, oh, ow)
    else:
        gate, inv = jnp.ones((oh, ow), bool), jnp.zeros((oh, ow), jnp.float32)
    with jax.enable_x64(exact):
        if st0.deep_trees is not None:
            ssum = jdense.dense_stage_deep(js, js, st0, oh, ow, inv, is_haar, exact=exact)
        elif is_haar:
            ssum = jdense.dense_stage_haar(js, js, st0, oh, ow, inv, exact=exact)
        else:
            ssum = jdense.dense_stage_lbp(js, st0, oh, ow, exact=exact)
        passed0 = np.asarray(ssum >= (jnp.float64 if exact else jnp.float32)(st0.threshold))
    gate = np.asarray(gate)
    m0 = jnp.asarray(gate & ~passed0)
    grid = jengine.static_visit_grid(jplan)
    if jplan.packed:
        plane_rows = jplan.row_is_plane[:oh, None]
        plane_grid = grid & plane_rows
        band_grid = jplan.grid2d & ~plane_rows
        visited = np.where(
            plane_rows,
            np.asarray(jengine.parity_visited(m0, jnp.asarray(plane_grid))),
            np.asarray(jengine.parity_visited(m0, jnp.asarray(band_grid),
                                              reset=jnp.asarray(~band_grid))),
        )
        grid = plane_grid | band_grid
    else:
        visited = np.asarray(jengine.parity_visited(m0, jnp.asarray(grid)))
    alive = torch.from_numpy(gate & grid & passed0 & visited)
    return (torch.from_numpy(np.array(inv)) if is_haar else None), alive


def _same(got, want):
    """(inv_nf, alive) equal: inv_nf bit for bit (or both None), alive exactly."""
    (ginv, galive), (winv, walive) = got, want
    assert (ginv is None) == (winv is None)
    if winv is not None:
        assert ginv.dtype == winv.dtype == torch.float32
        assert torch.equal(ginv.cpu().view(torch.int32), winv.cpu().view(torch.int32))
    assert galive.dtype == walive.dtype == torch.bool
    assert torch.equal(galive.cpu(), walive.cpu())


@pytest.mark.parametrize("name,exact", [("alt", False), ("alt", True), ("alt2", True),
                                        ("lbp", False)])
@pytest.mark.parametrize("packed", [False, True])
def test_twin_matches_jax_prep_composition(name, exact, packed):
    """Engine.prep on CPU tensors (the twin) == the JAX package's prep on
    the same canvases, for every cascade kind, both sum types and both
    plans; a frame with flat regions, so the gate fails at some grid
    windows."""
    det, plan, s, q, _ = _prep_inputs(name, 200, 150, packed, exact, flat=True)
    jpacked = JPackedCascade.from_model(jread_cascade_xml(os.path.join(DATA, XMLS[name])))
    jplan = jbuild_plan(200, 150, jpacked.win_w, jpacked.win_h, 1.1, None, None,
                        pack_band=packed)
    assert (jplan.canvas_h, jplan.canvas_w) == (plan.canvas_h, plan.canvas_w)
    got = det.engine.prep(s, q, plan)
    want = _jax_prep(jnp.asarray(s.numpy()), jnp.asarray(q.numpy()), jplan, jpacked, exact)
    _same(got, want)
    assert want[1].sum() > 0
    if want[0] is not None:
        grid = torch.as_tensor(dense.static_visit_grid(plan))
        assert (grid & (want[0] == 1)).sum() > 0  # gated-out windows on the grid
    if packed:
        assert want[1][~torch.as_tensor(plan.row_is_plane[: plan.out_h])].sum() > 0  # the band


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("w,h", [(320, 240), (301, 187)])
def test_code_plane_reproduces_the_walk_inputs(w, h, packed):
    """The code plane built once a plan encodes static_visit_grid, its
    ordinal and the shelf-packed plan's resets (band rows off the grid);
    the plain stack has none."""
    plan = build_plan(w, h, 20, 20, 1.1, pack_band=packed)
    code_np = walk_code(plan)
    assert code_np.dtype == np.uint8 and code_np.shape == (plan.out_h, plan.out_w)
    assert not (code_np & ~np.uint8(ON_GRID | RESET)).any()
    grid_np = dense.static_visit_grid(plan)
    grid, ordinal, reset = walk_inputs(torch.from_numpy(code_np))
    np.testing.assert_array_equal(grid.numpy(), grid_np)
    np.testing.assert_array_equal(ordinal.numpy(), np.cumsum(grid_np, axis=1, dtype=np.int32))
    want_reset = np.zeros_like(grid_np)
    if packed:
        want_reset = ~plan.row_is_plane[: plan.out_h, None] & ~grid_np
        assert want_reset.any()
    np.testing.assert_array_equal(reset.numpy(), want_reset)
    det = TorchDetector(_model("alt"), device="cpu", engine="fused", pack_band=packed)
    assert det.engine._plan_tensors(plan)[1] is det.engine._plan_tensors(plan)[1]
    np.testing.assert_array_equal(det.engine._plan_tensors(plan)[1].numpy(), code_np)


def test_wrapper_sends_cpu_tensors_and_ref_to_the_twin(monkeypatch):
    """A CPU tensor, and impl="ref", run the twin: the kernel library is
    never loaded and no launch is counted. Tilted cascades are refused."""
    det, plan, s, q, code = _prep_inputs("alt", 160, 120, True, exact=False)

    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_library)
    before = _build.LAUNCHES["prep"]
    want = prep_ref(s, q, code, det.packed, exact=False)
    for impl in ("auto", "ref"):
        _same(prep(s, q, code, det.packed, impl=impl), want)
    assert _build.LAUNCHES["prep"] == before
    with pytest.raises(ValueError):
        prep(s, q, code, det.packed, impl="kernel")
    body = TorchDetector(read_cascade_xml(os.path.join(DATA, "haarcascade_upperbody.xml")),
                         device="cpu")
    with pytest.raises(ValueError):
        prep(s, q, code, body.packed)


def _walk_through(set_bits: int, flip: int, before: bool) -> bool:
    """csrc/prep.cu's walk_through on 32-bit words."""
    if set_bits:
        flip &= ~((2 << (set_bits.bit_length() - 1)) - 1) & 0xFFFFFFFF
        before = True
    return before != bool(bin(flip).count("1") & 1)


def _ballot(bits) -> int:
    return int(np.dot(np.asarray(bits, np.int64), 1 << np.arange(WARP, dtype=np.int64)))


def _walk_in_numpy(m0, on, reset):
    """The kernel's walk, replayed: per row, tiles of 128 columns from the
    left with the carry starting true; in a tile four warps of 32 lanes
    ballot their set bits (reset, or on with m0 false) and flip bits (on
    with m0 true); a lane's bit is the carry through the warps to its left
    and through its own warp's lanes below it; then the carry passes
    through all four warps. Columns past the row's end ballot nothing.
    Returns the visited bit of every column (before the AND with on)."""
    h, w = m0.shape
    out = np.zeros((h, w), bool)
    for r in range(h):
        carry = True
        for c0 in range(0, w, TILE_W):
            words = []
            for wx in range(TILE_W // WARP):
                cols = c0 + wx * WARP + np.arange(WARP)
                ok = cols < w
                cc = np.minimum(cols, w - 1)
                on_, rst, m = on[r, cc] & ok, reset[r, cc] & ok, m0[r, cc]
                words.append((_ballot(rst | (on_ & ~m)), _ballot(on_ & m)))
            for wx, (set_bits, flip) in enumerate(words):
                bit = carry
                for prev in words[:wx]:
                    bit = _walk_through(*prev, bit)
                for lane in range(WARP):
                    col = c0 + wx * WARP + lane
                    if col < w:
                        below = (1 << lane) - 1
                        out[r, col] = _walk_through(set_bits & below, flip & below, bit)
            for word in words:
                carry = _walk_through(*word, carry)
    return out


@pytest.mark.parametrize("seed,w", [(0, 300), (1, 128), (2, 129), (3, 517)])
def test_kernel_walk_replay_matches_parity_visited(seed, w):
    """Random triggers, grids and resets on rows that end inside a warp,
    on a tile's edge and one past it, runs of flips across warps and tiles
    (a sparse trigger), against the closed form."""
    rng = np.random.default_rng(seed)
    shape = (9, w)
    m0 = rng.random(shape) < (0.4 if seed % 2 else 0.97)
    on = rng.random(shape) < 0.7
    reset = ~on & (rng.random(shape) < (0.05 if seed % 2 else 0.3))
    got = on & _walk_in_numpy(m0, on, reset)
    want = dense.parity_visited(torch.from_numpy(m0), torch.from_numpy(on),
                                reset=torch.from_numpy(reset))
    np.testing.assert_array_equal(got, want.numpy())
    no_reset = np.zeros_like(reset)
    np.testing.assert_array_equal(
        on & _walk_in_numpy(m0, on, no_reset),
        dense.parity_visited(torch.from_numpy(m0), torch.from_numpy(on)).numpy())


@pytest.mark.parametrize("packed", [False, True])
def test_kernel_walk_replay_on_a_plan_matches_the_twin(packed):
    """The replay on a real plan's code plane and a frame's m0 = gate ∧
    ¬passed0 gives the twin's alive."""
    det, plan, s, q, code = _prep_inputs("alt", 173, 131, packed, exact=False, flat=True)
    c = det.packed
    gate, inv = dense.dense_variance_gate(s, q, c.win_w, c.win_h, plan.out_h, plan.out_w)
    passed0 = dense.stage_pass(s, c.stages[0], plan.out_h, plan.out_w, inv)
    grid, _, reset = walk_inputs(code)
    m0 = (gate & ~passed0).numpy()
    alive = gate.numpy() & grid.numpy() & passed0.numpy() & _walk_in_numpy(
        m0, grid.numpy(), reset.numpy())
    want = prep_ref(s, q, code, c)[1].numpy()
    assert want.sum() > 0
    np.testing.assert_array_equal(alive, want)


# ----------------------------------------------------------------------
# on the card

CARD_CASES = [("alt", False), ("alt", True), ("alt2", False), ("alt2", True), ("lbp", False),
              ("lbp", True)]
CARD_SIZES = [(1920, 1080), (3840, 2160), (301, 187)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("w,h", CARD_SIZES)
def test_kernel_matches_twin_on_card(cuda_device, w, h, packed):
    """Every kind and sum type (stump Haar, node trees, LBP; f32, f64) on
    1080p, 4K and an odd small frame whose window grid is no multiple of
    128 columns: inv_nf bit for bit, alive exactly."""
    for name, exact in CARD_CASES:
        det, plan, s, q, code = _prep_inputs(name, w, h, packed, exact, device=cuda_device)
        got = prep(s, q, code, det.packed, exact=exact)
        want = prep(s, q, code, det.packed, impl="ref", exact=exact)
        torch.cuda.synchronize()
        if w == 301:
            assert plan.out_w % TILE_W != 0
        _same(got, want)
        assert want[1].sum() > 0, (name, exact)
        del got, want, s, q


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_kernel_matches_twin_on_flat_regions_on_card(cuda_device, packed):
    """A 1080p frame with flat regions, where nf² ≤ 0 and the gate fails,
    for the gated kinds in both sum types."""
    for name, exact in CARD_CASES[:4]:
        det, plan, s, q, code = _prep_inputs(name, 1920, 1080, packed, exact, flat=True,
                                             device=cuda_device)
        got = prep(s, q, code, det.packed, exact=exact)
        want = prep(s, q, code, det.packed, impl="ref", exact=exact)
        torch.cuda.synchronize()
        _same(got, want)
        grid = (code & ON_GRID) != 0
        assert (grid & (want[0] == 1)).sum() > 1000, name  # the flat regions are gated out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["alt", "alt2", "lbp"])
def test_one_prep_launch_a_frame_on_card(cuda_device, name):
    """A frame through the fused engine launches the prep kernel once, and
    its raw windows equal the twin path's."""
    det = TorchDetector(_model(name), device=cuda_device, engine="fused")
    ref = TorchDetector(_model(name), device=cuda_device, engine="fused", impl="ref")
    img = _frame(640, 480)
    det.raw_windows(img)  # build and warm
    _build.LAUNCHES.clear()
    _, idx = det.raw_windows(img)
    assert _build.LAUNCHES["prep"] == 1
    np.testing.assert_array_equal(idx, ref.raw_windows(img)[1])
