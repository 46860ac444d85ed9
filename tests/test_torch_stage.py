"""Stage kernel of the PyTorch port (kernel ``stage``) against the JAX
package's tiled stage kernel ``make_pallas_chunk_fn`` (interpret mode)
and its XLA ``dense_stage_haar``, on the tilted upper-body cascade; and
the packing of tilted cascades."""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.dense import (  # noqa: E402
    dense_stage_haar as jdense_stage_haar,
)
from cascadeclassifier_tpu.detect.dense import (  # noqa: E402
    dense_tilted_rect_sum as jdense_tilted_rect_sum,
)
from cascadeclassifier_tpu.detect.dense import dense_variance_gate  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    _build_canvas,
    _resize_matrices,
    plan_tables,
)
from cascadeclassifier_tpu.detect.pallas_stage import (  # noqa: E402
    TILT_BIAS,
    make_pallas_chunk_fn,
)
from cascadeclassifier_tpu.detect.pyramid import build_plan  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import (  # noqa: E402
    read_cascade_xml as jread_cascade_xml,
)
from cascadeclassifier_tpu_torch.convert import from_jax_packed  # noqa: E402
from cascadeclassifier_tpu_torch.detect.dense import (  # noqa: E402
    dense_stage_haar,
    dense_tilted_rect_sum,
)
from cascadeclassifier_tpu_torch.detect.detector import PackedCascade  # noqa: E402
from cascadeclassifier_tpu_torch.detect.stage import stage  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import FEATURE_LBP  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    STAGE_RANGES,
    edge_mismatches,
)
from cascadeclassifier_tpu_torch.utils.synth import synth_frame  # noqa: E402

UPPERBODY = os.path.join(  # the port's vendored copy of OpenCV's file
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data", "haarcascade_upperbody.xml",
)
WIN_W, WIN_H = 22, 18


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup():
    """Synth frame 0 at 160x120, sf 1.2: the JAX canvases (sum, tilted),
    gate and inv_nf as the JAX detector builds them, and both packings."""
    jpacked = JPackedCascade.from_model(jread_cascade_xml(UPPERBODY))
    w, h = 160, 120
    img = synth_frame(0, h, w)
    plan = build_plan(w, h, WIN_W, WIN_H, 1.2, None, None)
    pad = int(plan.scaled_h.max()) + 1
    sum2d, sq2d, tilt2d = _build_canvas(
        jnp.asarray(img), plan_tables(plan), w, h, need_sq=True, need_tilted=True,
        tilt_pad=pad, resize_mats=_resize_matrices(plan),
    )
    out_h, out_w = plan.canvas_h - WIN_H, plan.canvas_w - WIN_W
    gate, inv_nf = dense_variance_gate(sum2d, sq2d, WIN_W, WIN_H, out_h, out_w)
    t = {k: torch.from_numpy(np.array(v))
         for k, v in dict(sum2d=sum2d, tilt2d=tilt2d, inv_nf=inv_nf, gate=gate).items()}
    return dict(jpacked=jpacked, cas=from_jax_packed(jpacked), plan=plan, out_h=out_h,
                out_w=out_w, jax=(sum2d, tilt2d, gate, inv_nf), t=t)


def _pallas(s, stage_ids):
    """make_pallas_chunk_fn over stage_ids, its inputs padded and biased
    as TPUDetector._submit_one pads them → (alive', passed0) numpy."""
    plan, out_h, out_w = s["plan"], s["out_h"], s["out_w"]
    sum2d, tilt2d, gate, inv_nf = s["jax"]
    fn, (hp, wp, halo_h, halo_w) = make_pallas_chunk_fn(
        s["jpacked"].stages, stage_ids, WIN_W, WIN_H, plan.canvas_h, plan.canvas_w,
        tile_h=128, tile_w=256, collect_passed0=stage_ids[0] == 0, use_tilted=True,
        interpret=True,
    )
    ch, cw = plan.canvas_h, plan.canvas_w
    sum_pad = jnp.zeros((hp + halo_h, wp + halo_w), jnp.int32).at[:ch, :cw].set(sum2d)
    tilt_pad = jnp.zeros((hp + halo_h, wp + halo_w), jnp.int32).at[
        :ch, TILT_BIAS : TILT_BIAS + cw].set(tilt2d)
    inv_pad = jnp.ones((hp, wp), jnp.float32).at[:out_h, :out_w].set(inv_nf)
    alive = jnp.zeros((hp, wp), bool).at[:out_h, :out_w].set(gate)
    a, p0 = fn(sum_pad, tilt_pad, inv_pad, alive)
    return np.asarray(a)[:out_h, :out_w], np.asarray(p0)[:out_h, :out_w]


@pytest.mark.parametrize("s0,s1", [(0, 3), (1, 3)])
def test_twin_matches_pallas_chunk_kernel(setup, s0, s1):
    """Stages 0-2 with stage 0's pass mask collected, and the chunk that
    starts at stage 1 (passed0 all False), for both outputs."""
    s = setup
    t = s["t"]
    want_alive, want_p0 = _pallas(s, list(range(s0, s1)))
    alive, p0 = stage(t["sum2d"], t["tilt2d"], t["inv_nf"], t["gate"], s["cas"], s0, s1)
    np.testing.assert_array_equal(alive.numpy(), want_alive)
    np.testing.assert_array_equal(p0.numpy(), want_p0)
    assert want_alive.sum() > 0  # non-vacuous
    assert want_p0.any() == (s0 == 0)


def test_tilted_rect_sum_matches_jax(setup):
    """Every tilted rect of stage 0 at every window, equal to the JAX
    int32 value (negative where a window straddles a block top)."""
    s = setup
    _, tilt2d, _, _ = s["jax"]
    st = s["cas"].stages[0]
    lowest = 0
    for i in np.nonzero(st.tilted)[0]:
        for r in range(3):
            if st.weights[i, r] == 0:
                continue
            args = (*(int(v) for v in st.feat_rects[i, r]), s["out_h"], s["out_w"])
            want = np.asarray(jdense_tilted_rect_sum(tilt2d, *args))
            got = dense_tilted_rect_sum(s["t"]["tilt2d"], *args).numpy()
            np.testing.assert_array_equal(got, want)
            lowest = min(lowest, int(want.min()))
    assert lowest < 0  # the straddling windows are in the comparison


def test_twin_matches_jax_dense_stage_haar_bitwise(setup):
    """Stage sums of the first 6 stages (f32, exact=False), bit for bit,
    at every window of the canvas."""
    s = setup
    t = s["t"]
    sum2d, tilt2d, _, inv_nf = s["jax"]
    n_tilted = 0
    for si in range(6):
        jst, st = s["jpacked"].stages[si], s["cas"].stages[si]
        n_tilted += int(st.tilted.sum())
        want = np.asarray(jdense_stage_haar(sum2d, tilt2d, jst, s["out_h"], s["out_w"],
                                            inv_nf, exact=False))
        got = dense_stage_haar(t["sum2d"], st, s["out_h"], s["out_w"], t["inv_nf"],
                               t["tilt2d"]).numpy()
        assert want.dtype == got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert n_tilted > 0


def test_packing_of_tilted_cascades():
    m = read_cascade_xml(UPPERBODY)
    ours = PackedCascade.from_model(m)
    jp = JPackedCascade.from_model(jread_cascade_xml(UPPERBODY))
    conv = from_jax_packed(jp)
    assert ours.has_tilted and conv.has_tilted and jp.has_tilted
    assert len(ours.stages) == 30
    assert sum(st.ntrees for st in ours.stages) == 2423
    assert sum(int(st.tilted.sum()) for st in ours.stages) == 474
    for a, b, j in zip(ours.stages, conv.stages, jp.stages):
        for f in ("feat_rects", "weights", "tilted", "thr", "left_leaf", "right_leaf"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(a, f), getattr(j, f))
    tab = ours.device_table("cpu")
    assert tab["has_tilted"] and tuple(tab["records"].shape) == (2423, 48)


def test_packing_rejects_what_is_not_ported_or_escapes_the_window():
    m = read_cascade_xml(UPPERBODY)
    st = PackedCascade.from_model(m).stages[0]
    ti = int(np.nonzero(st.tilted)[0][0])
    x, y, w, h = st.feat_rects[ti, 0]
    bad = st.feat_rects.copy()
    bad[ti, 0, 0] = h - 1  # x − h = −1: the corner (x−h, y+h) leaves the window
    with pytest.raises(ValueError):
        PackedCascade(win_w=WIN_W, win_h=WIN_H, stages=[dataclasses.replace(st, feat_rects=bad)])
    # the same rect upright is inside: only the tilted geometry refuses it
    up = dataclasses.replace(st, feat_rects=bad, tilted=np.zeros_like(st.tilted))
    PackedCascade(win_w=WIN_W, win_h=WIN_H, stages=[up])
    with pytest.raises(NotImplementedError):
        PackedCascade.from_model(dataclasses.replace(m, feature_type=FEATURE_LBP))
    tree = m.stages[0].trees[0]
    deep = dataclasses.replace(
        tree, left=np.array([1, 0], np.int32), right=np.array([-1, -2], np.int32),
        feature_idx=np.array([0, 1], np.int32),
        threshold=np.array([0.0, 0.0], np.float32),
        leaf_values=np.array([0.1, -0.1, 0.2], np.float32),
    )
    deep_stage = dataclasses.replace(m.stages[0], trees=[deep, *m.stages[0].trees[1:]])
    with pytest.raises(NotImplementedError):
        PackedCascade.from_model(dataclasses.replace(m, stages=[deep_stage]))


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(setup, cuda_device):
    s = setup
    args = [s["t"][k].to(cuda_device) for k in ("sum2d", "tilt2d", "inv_nf", "gate")]
    for s0, s1 in ((0, 30), (0, 1), (4, 30)):
        got = stage(*args, s["cas"], s0, s1)
        want = stage(*args, s["cas"], s0, s1, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_matches_twin_at_tile_edges_on_card(setup, cuda_device):
    """The front test's shapes and masks; stages [0, 30), [0, 1), [1, 30)
    and [5, 9) with the tilted canvas, and every stage of the upright
    frontal face with the integral canvas passed as the tilted one."""
    n, survivors, bad = edge_mismatches(setup["cas"], STAGE_RANGES, cuda_device, use_stage=True)
    torch.cuda.synchronize()
    assert not bad
    assert n == 48 and survivors > 0
    frontal = PackedCascade.from_model(read_cascade_xml(
        os.path.join(os.path.dirname(UPPERBODY), "haarcascade_frontalface_alt.xml")))
    assert not frontal.has_tilted
    n, _, bad = edge_mismatches(frontal, ((0, len(frontal.stages)),), cuda_device,
                                use_stage=True)
    torch.cuda.synchronize()
    assert not bad and n == 12
