"""Tilted canvas integral of the PyTorch port (kernel ``tilted``) against
the JAX package's ``dense.canvas_tilted`` and cv2.integral3."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.dense import canvas_tilted as jcanvas_tilted  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    _build_canvas,
    _resize_matrices,
    plan_tables,
)
from cascadeclassifier_tpu.detect.pyramid import build_plan  # noqa: E402
from cascadeclassifier_tpu_torch.convert import plan_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.detect.dense import canvas_tilted  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    build_pixel_canvas,
    resize_tables,
)
from cascadeclassifier_tpu_torch.detect.tilted import segments, tilted  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _canvas(w, h, sf, seed):
    """Random frame → (jax plan, port plan, port pixel canvas, JAX tilted
    canvas as the JAX detector builds it, pad)."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
    jplan = build_plan(w, h, 22, 18, sf, None, None)
    plan = plan_from_jax(jplan)
    pad = int(jplan.scaled_h.max()) + 1
    _, _, jt = _build_canvas(
        jnp.asarray(img), plan_tables(jplan), w, h, need_sq=True, need_tilted=True,
        tilt_pad=pad, resize_mats=_resize_matrices(jplan),
    )
    px = build_pixel_canvas(torch.from_numpy(img), plan, resize_tables(plan, "cpu"))
    return jplan, plan, px, np.asarray(jt), pad


@pytest.mark.parametrize("w,h,sf,seed", [(160, 120, 2.0, 1), (160, 120, 1.5, 2)])
def test_twin_matches_jax_canvas_tilted(w, h, sf, seed):
    """A 3-level and a 5-level plan of a 160x120 frame, equal mod 2^32
    (both int32), also against the JAX scan on the port's own canvas."""
    jplan, plan, px, jt, pad = _canvas(w, h, sf, seed)
    assert 3 <= len(plan.scales) <= 5
    got = canvas_tilted(px, plan.is_top, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jt)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcanvas_tilted(jnp.asarray(px.numpy()), jplan.is_top, pad))
    )
    assert np.abs(jt).max() > 0  # non-vacuous


def test_twin_matches_cv2_integral3_per_level():
    cv2 = pytest.importorskip("cv2")
    _, plan, px, _, pad = _canvas(160, 120, 1.5, 3)
    got = canvas_tilted(px, plan.is_top, pad).numpy()
    for s in range(len(plan.scales)):
        top, h_s, w_s = int(plan.block_top[s]), int(plan.scaled_h[s]), int(plan.scaled_w[s])
        level = px[top + 1 : top + 1 + h_s, 1 : 1 + w_s].numpy().astype(np.uint8)
        want = cv2.integral3(level)[2]
        np.testing.assert_array_equal(got[top : top + h_s + 1, : w_s + 1], want)


def _kernel_in_numpy(px, is_top, pad):
    """csrc/tilted.cu's algorithm, one segment at a time, in uint32 numpy:
    its segment split, its per-segment padding and its carried rows."""
    h, w = px.shape
    out = np.zeros((h, w), np.uint32)
    for start, end, p, top in segments(is_top, pad):
        d = w + 2 * p
        prev = np.zeros(d, np.uint32)
        prev2 = np.zeros(d, np.uint32)
        for y in range(start, end):
            if y == start and top:
                continue
            t = np.concatenate([[0], prev[:-1]]).astype(np.uint32)
            t += np.concatenate([prev[1:], [0]]).astype(np.uint32)
            t -= prev2
            t[p + 1 : p + w] += px[y, 1:].astype(np.uint32)
            if y > start and not (y - 1 == start and top):
                t[p + 1 : p + w] += px[y - 1, 1:].astype(np.uint32)
            prev, prev2 = t, prev
            out[y] = t[p : p + w]
    return out.view(np.int32)


@pytest.mark.parametrize("pad", [0, 3, 10, None, 500])
def test_kernel_algorithm_matches_twin_at_any_pad(pad):
    """The kernel pads each segment by min(pad, rows + 1) columns only;
    that equals the twin's uniform pad whether pad is too small to be
    exact, just enough, or larger."""
    _, plan, px, _, exact_pad = _canvas(160, 120, 1.2, 4)
    pad = exact_pad if pad is None else pad
    np.testing.assert_array_equal(
        _kernel_in_numpy(px.numpy(), plan.is_top, pad),
        canvas_tilted(px, plan.is_top, pad).numpy(),
    )


def test_segments_split_at_block_tops():
    _, plan, _, _, pad = _canvas(160, 120, 1.2, 4)
    seg = segments(plan.is_top, pad)
    np.testing.assert_array_equal(seg[:, 0], plan.block_top)
    np.testing.assert_array_equal(seg[:, 1], np.append(plan.block_top[1:], plan.canvas_h))
    assert seg[:, 3].all()
    np.testing.assert_array_equal(seg[:, 2], np.minimum(pad, seg[:, 1] - seg[:, 0] + 1))
    # a canvas whose row 0 is no block top still starts a segment there
    tops = np.zeros(10, bool)
    tops[4] = True
    np.testing.assert_array_equal(segments(tops, 2), [[0, 4, 2, 0], [4, 10, 2, 1]])


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device):
    _, plan, px, _, pad = _canvas(160, 120, 1.2, 5)
    pxd = px.to(cuda_device)
    for p in (pad, 4):
        got = tilted(pxd, plan.is_top, p)
        want = tilted(pxd, plan.is_top, p, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card_above_48kb_of_shared_memory(cuda_device):
    """A canvas 8000 wide padded by 300: the two carried rows take 67 KiB,
    past the 48 KB a launch gets without opting in."""
    rng = np.random.default_rng(6)
    h, w, pad = 600, 8000, 300
    px = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32))
    is_top = np.zeros(h, bool)
    is_top[[0, 290, 301]] = True
    px[torch.from_numpy(is_top)] = 0
    px[:, 0] = 0
    pxd = px.to(cuda_device)
    got = tilted(pxd, is_top, pad)
    want = tilted(pxd, is_top, pad, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
