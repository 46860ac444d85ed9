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
from cascadeclassifier_tpu_torch.detect.tilted import (  # noqa: E402
    CHUNK_ROWS,
    STRIP_COLS,
    segments,
    tilted,
    work_list,
)
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    tilted_edge_cases,
    tilted_edge_mismatches,
)


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
    """csrc/tilted.cu's algorithm in uint32 numpy: the launches in order,
    and in each launch one thread block per work item. A block holds the
    STRIP_COLS columns it owns and CHUNK_ROWS more on each side, takes
    zeros beyond them and outside the segment's padded row, starts from
    the state the launch before wrote (two buffers, swapped) and writes
    only its owned columns, to the canvas and to the state. Unwritten
    state and canvas cells hold a marker, so that a read of a cell nobody
    wrote would show."""
    h, w = px.shape
    seg = segments(is_top, pad)
    items, offsets = work_list(seg, w)
    state = np.full((2, len(seg), 2, w + 2 * int(seg[:, 2].max())), 0xDEADBEEF, np.uint32)
    out = np.full((h, w), 0x5A5A5A5A, np.uint32)
    tid = np.arange(STRIP_COLS + 2 * CHUNK_ROWS)
    zeros = np.zeros(len(tid), np.uint32)
    for c in range(len(offsets) - 1):
        state_in, state_out = state[c & 1], state[(c & 1) ^ 1]
        for s, q0, ka, _ in items[offsets[c] : offsets[c + 1]]:
            start, end, p, top = seg[s]
            yb, d = start + top, w + 2 * p
            rows = min(CHUNK_ROWS, end - yb - q0)
            k = ka - CHUNK_ROWS + tid
            x = k - p
            inside = (k >= 0) & (k < d)
            owned = inside & (k >= ka) & (k < ka + STRIP_COLS)
            on_canvas = owned & (x >= 0) & (x < w)
            has_pixel = inside & (x >= 1) & (x < w)
            if q0 == 0 and top:
                out[start, x[on_canvas]] = 0
            if rows <= 0:
                continue

            def pixels(y):
                row = zeros.copy()
                row[has_pixel] = px[y, x[has_pixel]].astype(np.uint32)
                return row

            t1, t2, above = zeros.copy(), zeros.copy(), zeros
            if q0 > 0:
                above = pixels(yb + q0 - 1)
                t1[inside], t2[inside] = state_in[s, 0, k[inside]], state_in[s, 1, k[inside]]
            for j in range(rows):
                cur = pixels(yb + q0 + j)
                left = np.concatenate([zeros[:1], t1[:-1]])
                right = np.concatenate([t1[1:], zeros[:1]])
                t0 = np.where(inside, left + right - t2 + cur + above, 0).astype(np.uint32)
                t2, t1, above = t1, t0, cur
                out[yb + q0 + j, x[on_canvas]] = t0[on_canvas]
            state_out[s, 0, k[owned]], state_out[s, 1, k[owned]] = t1[owned], t2[owned]
    return out.view(np.int32)


@pytest.mark.parametrize("pad", [0, 3, 10, None, 500])
def test_kernel_algorithm_matches_twin_at_any_pad(pad):
    """The kernel pads each segment by min(pad, (computed rows - 1) // 2)
    columns only; that equals the twin's uniform pad whether pad is too
    small to be exact, just enough, or larger."""
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
    # every segment's first row is its top: rows - 1 are computed
    np.testing.assert_array_equal(seg[:, 2], np.minimum(pad, (seg[:, 1] - seg[:, 0] - 2) // 2))
    assert (seg[:, 2] < pad).any() and (seg[:, 2] > 0).all()
    # a canvas whose row 0 is no block top still starts a segment there:
    # 4 computed rows, then a top and 5 computed rows
    tops = np.zeros(10, bool)
    tops[4] = True
    np.testing.assert_array_equal(segments(tops, 2), [[0, 4, 1, 0], [4, 10, 2, 1]])
    np.testing.assert_array_equal(segments(tops, 0), [[0, 4, 0, 0], [4, 10, 0, 1]])
    # a top alone, and a top in the last row: nothing computed, no padding
    tops[[5, 9]] = True
    np.testing.assert_array_equal(
        segments(tops, 7), [[0, 4, 1, 0], [4, 5, 0, 1], [5, 9, 1, 1], [9, 10, 0, 1]])


def test_work_list_covers_every_segment_in_chunks_and_strips():
    """Every computed row and padded column of every segment lies in one
    item; launch c holds chunk c of the segments that have one; a top
    alone gets one round of items in launch 0 (its zero row)."""
    tops = np.zeros(400, bool)
    tops[[0, 1, 3, 3 + CHUNK_ROWS + 1, 200]] = True  # runs: top alone, n = 1, 64, ..., 199
    w, pad = STRIP_COLS + 5, 40
    seg = segments(tops, pad)
    items, offsets = work_list(seg, w)
    assert items.dtype == offsets.dtype == np.int32 and offsets[0] == 0
    assert offsets[-1] == len(items) and (np.diff(offsets) > 0).all()
    n = seg[:, 1] - seg[:, 0] - seg[:, 3]
    assert n.tolist() == [0, 1, CHUNK_ROWS, 200 - (3 + CHUNK_ROWS + 1) - 1, 199]
    assert len(offsets) - 1 == -(-199 // CHUNK_ROWS)
    for s in range(len(seg)):
        d = w + 2 * seg[s, 2]
        cover = np.zeros((max(n[s], 1), d), np.int32)
        for c in range(len(offsets) - 1):
            for si, q0, ka, _ in items[offsets[c] : offsets[c + 1]]:
                if si == s:
                    assert q0 == c * CHUNK_ROWS and ka % STRIP_COLS == 0
                    cover[q0 : q0 + CHUNK_ROWS, ka : ka + STRIP_COLS] += 1
        assert (cover == 1).all(), s


@pytest.mark.parametrize("case", range(28))
def test_kernel_algorithm_matches_twin_on_the_edge_cases(case):
    """utils/edges.py's canvases (runs of 1, 2 and 3 rows, runs one row
    short of, at and past a chunk, one of three chunks, a top in the last
    row, row 0 no top; widths of one column, narrower than a strip, and
    one below, at and above one and two strips) at pads 0, 3, exact and
    500."""
    px, is_top, pad = list(tilted_edge_cases())[case]
    np.testing.assert_array_equal(
        _kernel_in_numpy(px, is_top, pad),
        canvas_tilted(torch.from_numpy(px), is_top, pad).numpy(),
    )


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
def test_kernel_matches_twin_on_the_edge_cases_on_card(cuda_device):
    n, bad = tilted_edge_mismatches(cuda_device)
    torch.cuda.synchronize()
    assert n == 28 and not bad, bad


@pytest.mark.cuda
def test_kernel_matches_twin_on_card_above_48kb_of_shared_memory(cuda_device):
    """A canvas 8000 wide padded by up to 148: two rows of it would take 65
    KiB of shared memory, past the 48 KB a launch gets without opting in.
    The kernel cuts it into 33 strips and holds no row in shared memory."""
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
