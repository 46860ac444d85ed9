"""Canvas resize, variance gate, stage 0 and the OpenCV walk of the PyTorch
port against the JAX package (``detector._build_canvas``, ``dense.py``,
``engine.py``), on the same unpacked plans and images."""

import functools
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect import dense as jdense  # noqa: E402
from cascadeclassifier_tpu.detect import engine as jengine  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    TPUDetector,
    _build_canvas,
    _resize_matrices,
    plan_tables,
)
from cascadeclassifier_tpu.detect.pyramid import build_plan as jbuild_plan  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.convert import from_jax_packed, plan_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.detect import dense  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    build_pixel_canvas,
    positions_to_rects,
    resize_tables,
)
from cascadeclassifier_tpu_torch.detect.engine import Engine  # noqa: E402
from cascadeclassifier_tpu_torch.detect.integral import integral  # noqa: E402

from .utils_synth import face_blob_image  # noqa: E402

HAAR_ALT = os.path.join(  # the port's vendored copy of OpenCV's file
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data", "haarcascade_frontalface_alt.xml",
)
GEOMS = [(200, 150, 1.1, 5), (173, 131, 1.25, 6)]


@pytest.fixture(scope="module")
def jpacked():
    return JPackedCascade.from_model(read_cascade_xml(HAAR_ALT))


def _frame(w, h, seed):
    if seed == 5:
        pytest.importorskip("cv2")
        return face_blob_image(w, h, n=3, seed=seed)
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _canvases(w, h, sf, seed, pack_band=False, dtype=torch.int32):
    """(img, jax plan, jax (sum, sq), port plan, port (sum, sq)), built
    once per geometry, layout and pixel-canvas dtype for the whole module."""
    img = _frame(w, h, seed)
    jplan = jbuild_plan(w, h, 20, 20, sf, None, None, pack_band=pack_band)
    js, jq, _ = _build_canvas(
        jnp.asarray(img), plan_tables(jplan), w, h, need_sq=True,
        resize_mats=_resize_matrices(jplan),
    )
    plan = plan_from_jax(jplan)
    px = build_pixel_canvas(torch.from_numpy(img), plan, resize_tables(plan, "cpu"), dtype)
    assert px.dtype == dtype
    s, q = integral(px)
    return img, jplan, (js, jq), plan, (s, q)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
@pytest.mark.parametrize("pack_band", [False, True])
@pytest.mark.parametrize("w,h,sf,seed", GEOMS)
def test_canvas_matches_jax_build_canvas(w, h, sf, seed, pack_band, dtype):
    """The pixel canvas as the stage engine builds it (int32) and as the
    fused engine does (uint8), through the integral, on both layouts."""
    _, _, (js, jq), plan, (s, q) = _canvases(w, h, sf, seed, pack_band, dtype)
    assert plan.packed == pack_band
    assert tuple(s.shape) == (plan.canvas_h, plan.canvas_w)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("w,h,sf,seed", GEOMS)
def test_gate_and_stage0_match_jax_dense(w, h, sf, seed, jpacked):
    _, _, (js, jq), plan, (s, q) = _canvases(w, h, sf, seed)
    oh, ow = plan.out_h, plan.out_w
    jgate, jinv = jdense.dense_variance_gate(js, jq, 20, 20, oh, ow)
    gate, inv = dense.dense_variance_gate(s, q, 20, 20, oh, ow)
    assert int(gate.sum()) > 100
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    np.testing.assert_array_equal(
        inv.numpy().view(np.int32), np.asarray(jinv).view(np.int32)
    )
    cas = from_jax_packed(jpacked)
    for si in (0, 1):
        jsum = jdense.dense_stage_haar(
            js, js, jpacked.stages[si], oh, ow, jinv, exact=False
        )
        ssum = dense.dense_stage_haar(s, cas.stages[si], oh, ow, inv)
        np.testing.assert_array_equal(
            ssum.numpy().view(np.int32), np.asarray(jsum).view(np.int32)
        )


def test_prep_matches_jax_prep_composition(jpacked):
    """Engine.prep == gate ∧ grid ∧ stage-0 pass ∧ parity walk, built from
    the JAX package's dense.py / engine.py pieces."""
    w, h, sf, seed = GEOMS[0]
    _, jplan, (js, jq), plan, (s, q) = _canvases(w, h, sf, seed)
    oh, ow = plan.out_h, plan.out_w
    jgate, jinv = jdense.dense_variance_gate(js, jq, 20, 20, oh, ow)
    st0 = jpacked.stages[0]
    passed0 = jdense.dense_stage_haar(js, js, st0, oh, ow, jinv, exact=False) >= (
        jnp.float32(st0.threshold)
    )
    grid = jnp.asarray(jengine.static_visit_grid(jplan))
    visited = jengine.parity_visited(jgate & ~passed0, grid)
    want = np.asarray(jgate & grid & passed0 & visited)
    eng = Engine(from_jax_packed(jpacked), "cpu")
    inv, alive = eng.prep(s, q, plan)
    assert want.sum() > 0
    np.testing.assert_array_equal(alive.numpy(), want)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("w,h,sf", [(160, 120, 1.2), (137, 101, 1.1)])
def test_walk_matches_jax_parity_visited_and_scan(w, h, sf):
    rng = np.random.default_rng(2)
    jplan = jbuild_plan(w, h, 20, 20, sf)
    plan = plan_from_jax(jplan)
    oh = plan.out_h
    grid = dense.static_visit_grid(plan)
    np.testing.assert_array_equal(grid, jengine.static_visit_grid(jplan))
    m0 = rng.random((oh, plan.out_w)) < 0.35
    got = dense.parity_visited(torch.from_numpy(m0), torch.from_numpy(grid))
    want = jengine.parity_visited(jnp.asarray(m0), jnp.asarray(grid))
    scan = jdense.dense_walk_visited(
        jnp.asarray(m0),
        jnp.asarray(jplan.row_is_grid[:oh]),
        jnp.asarray(jplan.row_step2[:oh]),
        jnp.asarray(jplan.row_maxc[:oh]),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))


def test_packed_prep_matches_jax_plane_and_band_prep(jpacked):
    """On a shelf-packed plan, Engine.prep == the JAX engine's two preps
    composed on the canvas: ystep-2 rows walk on the row descriptors
    (``prep_plane``), band rows on grid2d with the gaps between levels
    resetting the walk (``prep_band``)."""
    w, h, sf, seed = GEOMS[0]
    _, jplan, (js, jq), plan, (s, q) = _canvases(w, h, sf, seed, True)
    oh, ow = plan.out_h, plan.out_w
    jgate, jinv = jdense.dense_variance_gate(js, jq, 20, 20, oh, ow)
    st0 = jpacked.stages[0]
    passed0 = jdense.dense_stage_haar(js, js, st0, oh, ow, jinv, exact=False) >= (
        jnp.float32(st0.threshold)
    )
    m0 = jgate & ~passed0
    plane_rows = jnp.asarray(jplan.row_is_plane[:oh, None])
    plane_grid = jnp.asarray(jengine.static_visit_grid(jplan)) & plane_rows
    band_grid = jnp.asarray(jplan.grid2d) & ~plane_rows
    visited = jnp.where(
        plane_rows,
        jengine.parity_visited(m0, plane_grid),
        jengine.parity_visited(m0, band_grid, reset=~band_grid),
    )
    grid = plane_grid | band_grid
    want = np.asarray(jgate & grid & passed0 & visited)
    eng = Engine(from_jax_packed(jpacked), "cpu")
    inv, alive = eng.prep(s, q, plan)
    assert want[~jplan.row_is_plane[:oh]].sum() > 0  # the band is not vacuous
    np.testing.assert_array_equal(alive.numpy(), want)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_with_reset_matches_jax_parity_visited(seed):
    rng = np.random.default_rng(seed)
    shape = (37, 300)
    m0 = rng.random(shape) < 0.4
    on = rng.random(shape) < 0.7
    reset = ~on & (rng.random(shape) < 0.3)
    got = dense.parity_visited(
        torch.from_numpy(m0), torch.from_numpy(on), reset=torch.from_numpy(reset)
    )
    want = jengine.parity_visited(jnp.asarray(m0), jnp.asarray(on), reset=jnp.asarray(reset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = dense.parity_visited(torch.from_numpy(m0), torch.from_numpy(on))
    assert not torch.equal(got, plain)  # the resets changed the walk


@pytest.mark.parametrize("w,h,sf", [(320, 240, 1.1), (1920, 1080, 1.1)])
def test_positions_to_rects_on_packed_plan(w, h, sf):
    """Every anchor of a shelf-packed plan maps as TPUDetector maps it,
    and the anchors of both layouts map to the same image-space rects."""
    rng = np.random.default_rng(3)
    packed = plan_from_jax(jbuild_plan(w, h, 20, 20, sf, pack_band=True))
    plain = plan_from_jax(jbuild_plan(w, h, 20, 20, sf))
    sel = np.flatnonzero(packed.grid2d)
    np.testing.assert_array_equal(
        positions_to_rects(packed, sel), TPUDetector._positions_to_rects(None, packed, sel)
    )
    pick = np.sort(rng.choice(sel, 500, replace=False))
    np.testing.assert_array_equal(
        positions_to_rects(packed, pick), TPUDetector._positions_to_rects(None, packed, pick)
    )

    def rect_set(plan, grid):
        return sorted(map(tuple, positions_to_rects(plan, np.flatnonzero(grid)).tolist()))

    assert rect_set(packed, packed.grid2d) == rect_set(plain, dense.static_visit_grid(plain))
