"""Cascade front of the PyTorch port (kernel 2) against the JAX package's
static Pallas front and parity-plane front (interpret mode)."""

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
    make_plane_front_fn,
    make_static_front_fn,
    plane_pad_geometry,
)
from cascadeclassifier_tpu.detect.pyramid import build_plan  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.convert import from_jax_packed  # noqa: E402
from cascadeclassifier_tpu_torch.detect.front import front  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    FRONT_RANGES,
    edge_mismatches,
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


@pytest.fixture(scope="module")
def setup():
    """Random 160x120 frame, as tests/test_detector.py's static-front test
    builds it: JAX canvas, gate and inv_nf, plus the port's cascade."""
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
    port = front(
        torch.from_numpy(np.array(sum2d)), torch.from_numpy(np.array(inv_nf)),
        torch.from_numpy(np.array(gate)), from_jax_packed(jpacked),
        STAGES[0], STAGES[-1] + 1,
    ).numpy()
    return dict(jpacked=jpacked, plan=plan, sum2d=sum2d, gate=gate,
                inv_nf=inv_nf, out_h=out_h, out_w=out_w, port=port)


def test_twin_matches_static_front_kernel(setup):
    s = setup
    jp, plan, out_h, out_w = s["jpacked"], s["plan"], s["out_h"], s["out_w"]
    fn, (hp, wp, hh, hw) = make_static_front_fn(
        jp.stages, STAGES, 20, 20, plan.canvas_h, plan.canvas_w, 64, 128,
        interpret=True,
    )
    sum_pad = pad_canvas_for_patchify(s["sum2d"], 20, hp + hh, wp + hw)
    inv_pad = jnp.ones((hp, wp), jnp.float32).at[:out_h, :out_w].set(s["inv_nf"])
    alive = jnp.zeros((hp, wp), jnp.int8).at[:out_h, :out_w].set(
        s["gate"].astype(jnp.int8)
    )
    want = np.asarray(fn(sum_pad, inv_pad, alive))[:out_h, :out_w] != 0
    assert want.sum() > 1000  # non-vacuous
    np.testing.assert_array_equal(s["port"], want)


def test_twin_matches_plane_front_kernel_on_even_anchors(setup):
    """make_plane_front_fn evaluates the (even, even) anchors of the rows
    above split_r from the four parity planes; mapped back to the canvas
    they must equal the port's canvas-layout mask there."""
    s = setup
    jp, plan, out_w = s["jpacked"], s["plan"], s["out_w"]
    split_r = int(plan.block_top[np.nonzero(plan.ystep == 1)[0][0]])
    th, tw = 32, 128
    fn, _ = make_plane_front_fn(
        jp.stages, STAGES, 20, 20, split_r, out_w, th, tw, interpret=True
    )
    hp2, wp2, hh2, hw2 = plane_pad_geometry(split_r, out_w, 20, 20, th, tw)
    ph, pw = hp2 + hh2, wp2 + hw2
    canvas = np.zeros((2 * ph, 2 * pw), np.int32)
    src = np.asarray(s["sum2d"])[: 2 * ph, : 2 * pw]
    canvas[: src.shape[0], : src.shape[1]] = src
    planes = jnp.asarray(
        np.stack([np.stack([canvas[a::2, b::2] for b in (0, 1)]) for a in (0, 1)])
    )
    rows2, cols2 = (split_r + 1) // 2, (out_w + 1) // 2
    gate = np.asarray(s["gate"])[0:split_r:2, 0::2]
    inv = np.asarray(s["inv_nf"])[0:split_r:2, 0::2]
    alive_p = np.zeros((hp2, wp2), np.int8)
    inv_p = np.ones((hp2, wp2), np.float32)
    alive_p[:rows2, :cols2] = gate
    inv_p[:rows2, :cols2] = inv
    got = np.asarray(fn(planes, jnp.asarray(inv_p), jnp.asarray(alive_p)))
    want = got[:rows2, :cols2] != 0
    assert want.sum() > 100  # non-vacuous
    np.testing.assert_array_equal(s["port"][0:split_r:2, 0::2], want)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(setup, cuda_device):
    s = setup
    cas = from_jax_packed(s["jpacked"])
    args = [torch.from_numpy(np.array(s[k])).to(cuda_device)
            for k in ("sum2d", "inv_nf", "gate")]
    got = front(*args, cas, 1, 8)
    want = front(*args, cas, 1, 8, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_matches_twin_at_tile_edges_on_card(setup, cuda_device):
    """Window grids one less than, equal to and one more than two tiles
    each way; every tile dead, every window alive, the last window alone
    and a checkerboard; stages [1, 8), [3, 5) and [4, 4)."""
    cas = from_jax_packed(setup["jpacked"])
    n, survivors, bad = edge_mismatches(cas, FRONT_RANGES, cuda_device, use_stage=False)
    torch.cuda.synchronize()
    assert not bad
    assert n == 36 and survivors > 0
