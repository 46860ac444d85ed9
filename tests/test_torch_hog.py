"""HOG in the port against the JAX package on the CPU: the catalog (and
the reference's golden geometry), the orientation bin and magnitude of
every (gx, gy) pair, the integral histograms bit for bit, a numpy replay
of hog_hist.cu's scan order, its plan and shared-memory layout, hog_eval's
grouping of the variables and a replay of its per-feature walk, the
responses (bit for bit against eval_hog,
within 2^-22 of the JAX evaluator's matrix product, whose order of adds
depends on its shapes: ROADMAP C.4), the evaluator's interface, a 32x32
HOG toy run against the JAX trainer, the HOG detector against the JAX
HOGDetector, and (cuda-marked) both kernels against their plain versions
on the card."""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cascadeclassifier_tpu.detect import grouping as jgrouping  # noqa: E402
from cascadeclassifier_tpu.detect.hog_detector import HOGDetector as JHOGDetector  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml as jread_cascade_xml  # noqa: E402
from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HOGTrainEvaluator as JHOGTrainEvaluator,
)
from cascadeclassifier_tpu.train.trainer import CascadeTrainer as JCascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.data.vec import write_vec  # noqa: E402
from cascadeclassifier_tpu_torch.detect import grouping  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import make_detector  # noqa: E402
from cascadeclassifier_tpu_torch.detect.hog_detector import HOGDetector  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import FEATURE_HOG  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.ops import hog  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import hog_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import (  # noqa: E402
    HOGTrainEvaluator,
    make_evaluator,
)
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.utils import profiling  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    hog_edge_mismatches,
    hog_id_cases,
)
from cascadeclassifier_tpu_torch.utils.time_grouping import detection_like, pair_set  # noqa: E402

from .test_features import _load_geom, _load_imgs, _load_resp  # noqa: E402

jhist_fn = jax.jit(jfeatures.hog_integral_histogram)
# |port - JAX evaluator| on responses in [0, 1] (ROADMAP C.4; measured at
# most 4.5e-8 on 3 072 random 32x32 windows)
EVALUATOR_ATOL = 2.0 ** -22


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _windows(h, w, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


def test_hog_catalog_matches_reference(golden_dir):
    count, rows = _load_geom(golden_dir, "geom_hog_20x16.txt.gz")
    cat = hog_catalog(20, 16)
    assert len(cat) == count
    ref = np.array([[int(v) for v in r[1:]] for r in rows], np.int32)
    np.testing.assert_array_equal(cat.rects, ref)


@pytest.mark.parametrize("win", [(16, 16), (20, 16), (24, 24), (32, 32), (48, 40)])
def test_hog_catalog_matches_original(win):
    ours, theirs = hog_catalog(*win), jfeatures.hog_catalog(*win)
    np.testing.assert_array_equal(ours.rects, theirs.rects)
    np.testing.assert_array_equal(ours.cell_corner_offsets(), theirs.cell_corner_offsets())
    assert ours.var_count == theirs.var_count


def test_hog_empty_for_small_window():
    """Mirrors tests/test_features.py::test_hog_empty_for_small_window."""
    assert len(hog_catalog(15, 15)) == 0
    assert len(hog_catalog(16, 16)) == 1
    assert len(hog_catalog(32, 32)) == 36


def test_every_gradient_pair_matches_original():
    """All 511² (gx, gy) pairs, each at the centre of a 3x3 window: the
    port's bin table gives the bin of the JAX package's histogram there,
    and the plain histograms (magnitudes included) equal JAX's bits."""
    g = np.arange(-255, 256)
    gx, gy = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    img = np.zeros((gx.size, 3, 3), np.uint8)
    img[:, 1, 0] = np.maximum(0, -gx)
    img[:, 1, 2] = img[:, 1, 0] + gx
    img[:, 0, 1] = np.maximum(0, -gy)
    img[:, 2, 1] = img[:, 0, 1] + gy
    jh, jn = (np.asarray(a) for a in jhist_fn(jnp.asarray(img)))
    centre = jh[:, :, 2, 2] - jh[:, :, 1, 2] - jh[:, :, 2, 1] + jh[:, :, 1, 1]
    moving = (gx != 0) | (gy != 0)
    table = hog.bin_table("cpu").numpy()
    np.testing.assert_array_equal(table[moving], np.abs(centre).argmax(1)[moving])
    h, n = hog.hog_integral_histogram(torch.from_numpy(img))
    np.testing.assert_array_equal(_bits(h), _bits(jh))
    np.testing.assert_array_equal(_bits(n), _bits(jn))


@pytest.mark.parametrize("h,w", [(16, 20), (24, 24), (32, 32), (17, 40)])
def test_hog_integral_histogram_matches_original(h, w):
    x = _windows(h, w, 40, h * w)
    x[:4] = 128  # flat: all-zero magnitudes
    jh, jn = jhist_fn(jnp.asarray(x))
    got_h, got_n = hog.hog_integral_histogram(torch.from_numpy(x))
    assert got_h.shape == (40, 9, h + 1, w + 1) and got_n.shape == (40, h + 1, w + 1)
    np.testing.assert_array_equal(_bits(got_h), _bits(jh))
    np.testing.assert_array_equal(_bits(got_n), _bits(jn))


def _hist_kernel_in_numpy(mag, bins):
    """hog_hist.cu's decomposition for one window: each channel's rows,
    then its columns, in runs of 16 with a carried prefix of the run
    totals (f32 adds in the kernel's order)."""
    f32 = np.float32
    h, w = mag.shape
    chans = [np.where(bins == c, mag, f32(0)) for c in range(9)] + [mag]
    out = np.zeros((10, h + 1, w + 1), f32)

    def scan(v):
        res = np.zeros_like(v)
        carry = f32(0)
        for x0 in range(0, len(v), 16):
            acc = f32(0)
            for x in range(x0, min(x0 + 16, len(v))):
                acc = f32(acc + v[x])
                res[x] = acc if x0 == 0 else f32(acc + carry)
            carry = acc if x0 == 0 else f32(carry + acc)
        return res

    for c, v in enumerate(chans):
        rows = np.stack([scan(r) for r in v])
        out[c, 1:, 1:] = np.stack([scan(col) for col in rows.T]).T
    return out


@pytest.mark.parametrize("h,w", [(3, 16), (17, 5), (24, 24), (33, 31), (20, 256)])
def test_hist_kernel_order_in_numpy_matches_plain(h, w):
    x = torch.from_numpy(_windows(h, w, 1, 7 * h + w))
    gx, gy = hog.gradients(x)
    mag = torch.sqrt((gx * gx + gy * gy).double()).float()[0].numpy()
    bins = hog.bin_table("cpu")[((gx + 255) * 511 + gy + 255).long()][0].numpy()
    got = _hist_kernel_in_numpy(mag, bins)
    ph, pn = hog.hog_integral_histogram(x)
    np.testing.assert_array_equal(_bits(got[:9]), _bits(ph[0]))
    np.testing.assert_array_equal(_bits(got[9]), _bits(pn[0]))


def _supported_sides():
    return [(h, w) for h in range(1, hog.MAX_SIDE + 1) for w in range(1, hog.MAX_SIDE + 1)
            if 5 * h * w <= hog.MAX_SHARED]


def test_hist_plan_covers_channels_and_fits():
    """For every size the wrapper takes: the channel groups cover channels
    0-9 once, the CTA's shared memory fits the card and the budget (but
    for a single plane that exceeds it), the stride is odd, the threads
    are whole warps; 24x24 and 32x32 take all 10 channels a CTA."""
    sides = _supported_sides()
    assert len(sides) > 50_000 and (181, 256) in sides and (256, 181) in sides
    for h, w in sides:
        plan = hog.hist_plan(h, w)
        chans = [c for lo, hi in plan.groups() for c in range(lo, hi)]
        assert chans == list(range(hog.CHANNELS)), (h, w, plan)
        plane = (h + 1) * plan.stride
        assert plan.stride % 2 == 1 and plan.stride in (w + 1, w + 2), (h, w, plan)
        assert plan.shared == hog.shared_bytes(plan.channels, plane)
        assert plan.shared <= hog.MAX_SHARED, (h, w, plan)
        assert plan.shared <= hog.HIST_BUDGET or plan.channels == 1
        assert plan.threads % 32 == 0 and 0 < plan.threads <= hog.MAX_THREADS
    for side in (24, 32):  # all 10 channels a CTA, 4 CTAs an SM
        plan = hog.hist_plan(side, side)
        assert plan.channels == 10 and 4 * plan.shared <= hog.MAX_SHARED


def _hist_layout_in_numpy(n, h, w, plan):
    """hog_hist.cu's shared layout and step 4's runs to device memory,
    replayed for every CTA (a window and channel group): checks that each
    CTA's planes fit its shared bytes without overlap and that each run
    agrees with its destination modulo 16 bytes where it is copied whole;
    → for each float of hist (n, 9, h+1, w+1) and of norm (n, h+1, w+1),
    (the shared index step 4 copies it from, the index of the plane it
    belongs to plus its row and column), both per CTA."""
    st, w1 = plan.stride, w + 1
    pp, p = (h + 1) * st, (h + 1) * w1
    at = np.arange(p) // w1 * st + np.arange(p) % w1  # output offset → shared offset
    got = {"hist": np.full(n * 9 * p, -1), "norm": np.full(n * p, -1)}
    want = {"hist": np.full(n * 9 * p, -2), "norm": np.full(n * p, -2)}

    def align(slot, dst):
        return slot + (((dst & 3) - (slot & 3)) & 3)

    for s in range(n):
        for c0, c1 in plan.groups():
            nb = max(0, min(c1, 9) - c0)
            hdst, ndst = (s * 9 + c0) * p, s * p
            hbase = align(0, hdst)
            nbase = align(hbase + nb * pp, ndst)
            starts = [hbase + j * pp for j in range(nb)] + ([nbase] if c1 == 10 else [])
            assert starts[0] >= 0 and all(b - a >= pp for a, b in zip(starts, starts[1:]))
            assert (starts[-1] + pp) * 4 <= plan.shared
            for j, start in enumerate(starts):
                c = c0 + j
                if c < 9:
                    want["hist"][(s * 9 + c) * p + np.arange(p)] = start + at
                else:
                    want["norm"][s * p + np.arange(p)] = start + at
            runs = ([("hist", hdst, hbase, nb)] if nb else []) + (
                [("norm", ndst, nbase, 1)] if c1 == 10 else [])
            for name, dst, src, planes in runs:
                if st == w1:  # copy_run: src + i
                    assert (src - dst) % 4 == 0
                i = np.arange(planes * p)  # copy_run (pp == p) and the row copy alike
                assert (got[name][dst + i] == -1).all()
                got[name][dst + i] = src + i // p * pp + at[i % p]
    return got, want


@pytest.mark.parametrize("n,h,w,channels", [
    (7, 24, 24, None),
    (7, 24, 24, 4),
    (5, 16, 17, 2),
    (4, 33, 20, 3),
    (5, 33, 20, 1),
    (3, 60, 200, None),
    (2, 181, 256, None),
    (2, 256, 181, None),
])
def test_hist_layout_in_numpy(n, h, w, channels):
    """Every output float is copied once, from its own window's and
    channel's plane, at its row and column, for the wrapper's plans and
    for channel groups that split the bins (utils/tune_hog.py's)."""
    plan = hog.hist_plan(h, w)
    if channels is not None:
        plane = (h + 1) * plan.stride
        plan = dataclasses.replace(plan, channels=channels,
                                   shared=hog.shared_bytes(channels, plane))
    got, want = _hist_layout_in_numpy(n, h, w, plan)
    for name in ("hist", "norm"):
        assert (got[name] >= 0).all(), name
        np.testing.assert_array_equal(got[name], want[name])


def test_constants_match_the_kernels():
    """ops/hog.py's mirrors of the kernels' constants."""
    import re

    def const(source, name):
        with open(os.path.join(_build.CSRC_DIR, source)) as f:
            return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))

    assert const("hog_hist.cu", "kSlack") == hog.SLACK
    assert const("hog_hist.cu", "kMaxThreads") == hog.MAX_THREADS
    assert const("hog_eval.cu", "kDirectMax") == hog.EVAL_DIRECT_MAX
    assert 227 * 1024 == hog.MAX_SHARED


def test_eval_plan_maps_back():
    """eval_plan's sorted ids are var_ids at its positions, each position
    once, and feature f's range holds exactly its ids."""
    rng = np.random.default_rng(5)
    nf = 9
    var_ids = np.concatenate([rng.integers(0, nf * 36, 50), [0, 0, nf * 36 - 1, 40, 40]])
    rng.shuffle(var_ids)
    ids, order, starts = hog.eval_plan(torch.from_numpy(var_ids), nf)
    np.testing.assert_array_equal(ids.numpy(), var_ids[order.numpy()])
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(len(var_ids)))
    assert starts.shape == (nf + 1,) and starts[0] == 0 and starts[-1] == len(var_ids)
    for f in range(nf):
        part = ids[starts[f]:starts[f + 1]].numpy()
        assert (part // 36 == f).all()
        assert len(part) == (var_ids // 36 == f).sum()
    empty = hog.eval_plan(torch.zeros(0, dtype=torch.int64), nf)[2]
    assert (empty == 0).all()


def test_corner_grid_tables():
    """hog_eval.cu's point() and defining() mirrored in ops/hog.py; the
    catalog's corner tables are grids, a skewed one is not, and the
    evaluator refuses it."""
    for q in range(9):
        k, c = divmod(int(hog.GRID_CORNER[q]), 4)
        assert hog.GRID_POINT[k, c] == q
        assert int(hog.GRID_CORNER[q]) == min(4 * k + c for k in range(4) for c in range(4)
                                              if hog.GRID_POINT[k, c] == q)
    assert hog.GRID_POINT[:, 0].tolist() == [0, 1, 3, 4]
    for win in ((16, 20), (24, 24), (32, 32), (48, 40)):
        cat = hog_catalog(*win)
        cells = cat.cell_corner_offsets()
        assert hog.is_corner_grid(cells)
        skew = cells.copy()
        skew[len(skew) // 2, 3, 0] += 1  # cell 3's top left corner off the grid
        assert not hog.is_corner_grid(skew)
    cat.cell_corner_offsets = lambda: skew
    with pytest.raises(ValueError, match="2x2 grid"):
        HOGTrainEvaluator(cat, device="cpu")


def _eval_kernel_in_torch(hist, norm, cells, var_ids):
    """hog_eval.cu's walk on eval_plan's groups: per feature, the asked
    variables, the norm's 4 corners, per bin asked the grid points its
    cells need, each asked cell's response, then each variable to its
    row."""
    n, nf = hist.shape[0], cells.shape[0]
    ids, order, starts = hog.eval_plan(var_ids, nf)
    out = torch.full((len(var_ids), n), float("nan"))
    eps = torch.tensor(hog.HOG_EPS)
    grid = torch.from_numpy(hog.GRID_CORNER)

    def corners(v):
        return ((v[:, 0] - v[:, 1]) - v[:, 2]) + v[:, 3]

    for f in range(nf):
        lo, hi = int(starts[f]), int(starts[f + 1])
        if lo == hi:
            continue
        comps = ids[lo:hi] - f * 36
        asked = set(comps.tolist())
        o = cells[f].reshape(16).long()
        den = corners(norm[:, o[[0, 5, 10, 15]]]) + eps
        resp = torch.zeros((36, n))
        for b in range(9):
            for k in (k for k in range(4) if k * 9 + b in asked):
                cs = corners(hist[:, b, o[grid]][:, hog.GRID_POINT[k]])
                resp[k * 9 + b] = torch.where(cs > eps, cs / den, 0.0)
        out[order[lo:hi]] = resp[comps]
    return out


@pytest.mark.parametrize("h,w", [(16, 20), (24, 24), (32, 32)])
def test_eval_kernel_walk_in_torch_matches_plain(h, w):
    """The replay of hog_eval.cu's per-feature walk equals the plain
    version bit for bit on every variable and on hog_id_cases' lists."""
    n = 24
    x = torch.from_numpy(_windows(h, w, n, 2 * h + w))
    hist, norm = hog.hog_integral_histogram(x)
    hist, norm = hist.reshape(n, 9, -1), norm.reshape(n, -1)
    cat = hog_catalog(w, h)
    cells = torch.from_numpy(cat.cell_corner_offsets())
    lists = [np.arange(cat.var_count)] + [ids for _, ids in hog_id_cases(cat.var_count, h)]
    for ids in lists:
        ids = torch.from_numpy(np.asarray(ids, np.int64))
        got = _eval_kernel_in_torch(hist, norm, cells, ids)
        np.testing.assert_array_equal(_bits(got), _bits(hog.hog_responses_ref(hist, norm, cells,
                                                                               ids)))


def _responses(x):
    """The port's evaluator and the JAX one on the same windows."""
    h, w = x.shape[1:]
    ev = HOGTrainEvaluator(hog_catalog(w, h), device="cpu")
    jev = JHOGTrainEvaluator(jfeatures.hog_catalog(w, h))
    ev.set_samples(x)
    jev.set_samples(x)
    return ev, jev


@pytest.mark.parametrize("h,w", [(16, 20), (24, 24), (32, 32)])
def test_responses_match_eval_hog(h, w):
    """Bit for bit against the JAX package's eval_hog (the same gather
    and order of adds), in the evaluator's var order."""
    x = _windows(h, w, 64, h + w)
    ev, _ = _responses(x)
    jh, jn = jhist_fn(jnp.asarray(x))
    cells = jfeatures.hog_catalog(w, h).cell_corner_offsets()
    want = np.asarray(jfeatures.eval_hog(jh.reshape(64, 9, -1), jn.reshape(64, -1),
                                         jnp.asarray(cells))).T
    np.testing.assert_array_equal(_bits(ev.values_block(0)), _bits(want))


@pytest.mark.parametrize("h,w,n", [(16, 20, 50), (24, 24, 300), (32, 32, 256)])
def test_responses_match_evaluator_within_tolerance(h, w, n):
    """values_block and values_for_vars against the JAX evaluator's
    einsum: equal structure (zeros where JAX has zeros but for the
    ±1e-3 select), values within 2^-22 (ROADMAP C.4)."""
    x = _windows(h, w, n, 3 * h + n)
    ev, jev = _responses(x)
    got, want = ev.values_block(0).numpy(), np.asarray(jev.values_block(0))
    assert got.shape == want.shape == (ev.var_count, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=EVALUATOR_ATOL)
    assert (got == want).mean() > 0.5
    ids = np.array([5, 40 % ev.var_count, 3, ev.var_count - 1, 37 % ev.var_count, 5])
    np.testing.assert_allclose(ev.values_for_vars(ids).numpy(),
                               np.asarray(jev.values_for_vars(ids)), rtol=0,
                               atol=EVALUATOR_ATOL)
    np.testing.assert_array_equal(ev.values_for_vars(ids).numpy(), got[ids])


def test_responses_match_reference(golden_dir):
    """Mirrors tests/test_features.py::test_hog_responses_match_reference
    (the reference binary's responses, same tolerance)."""
    w, h = 20, 16
    cat = hog_catalog(w, h)
    imgs = _load_imgs(golden_dir, "img_hog_20x16.txt.gz", h, w)
    ref = _load_resp(golden_dir, "resp_hog_20x16.txt.gz", cat.var_count)
    ev = HOGTrainEvaluator(cat, device="cpu")
    ev.set_samples(imgs)
    np.testing.assert_allclose(ev.values_block(0).numpy().T, ref, rtol=1e-4, atol=1e-5)


def test_hog_evaluator_interface():
    ev = make_evaluator(FEATURE_HOG, 32, 32, device="cpu")
    assert isinstance(ev, HOGTrainEvaluator)
    assert (ev.featSize, ev.maxCatCount, ev.var_count, ev.num_features) == (36, 0, 1296, 36)
    small = HOGTrainEvaluator(hog_catalog(32, 32), block_size=36 * 10, device="cpu")
    assert small.num_blocks() == 4 and small.block_slice(3) == (1080, 1296)
    small.set_samples(_windows(32, 32, 9, 1))
    np.testing.assert_array_equal(small.values_block(3).numpy(),
                                  small.values_for_vars(np.arange(1080, 1296)).numpy())
    with pytest.raises(ValueError):
        HOGTrainEvaluator(hog_catalog(32, 32), block_size=100, device="cpu")


def _floats_close(a: bytes, b: bytes):
    """Two XML files token by token: every token equal, but for numbers,
    which agree within 1e-6 relative (the thresholds of C.4)."""
    ta, tb = a.decode().split(), b.decode().split()
    assert len(ta) == len(tb)
    diff = 0
    for x, y in zip(ta, tb):
        if x == y:
            continue
        assert abs(float(x) - float(y)) <= 1e-6 * max(abs(float(y)), 1e-30), (x, y)
        diff += 1
    return diff


@pytest.fixture(scope="module")
def hog_toy(tmp_path_factory):
    """tests/test_train.py::test_hog_train_and_detect_round_trip's data:
    150 32x32 positives with a bright vertical bar, one 96x128 noise
    background; both trainers, 2 stages requested."""
    d = str(tmp_path_factory.mktemp("hogtoy"))
    rng = np.random.default_rng(9)
    pos = rng.integers(90, 110, (150, 32, 32)).astype(np.uint8)
    pos[:, :, 12:20] = rng.integers(230, 255, (150, 32, 8))
    write_vec(os.path.join(d, "pos.vec"), pos)
    bg = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    with open(os.path.join(d, "bg.pgm"), "wb") as f:
        f.write(b"P5\n128 96\n255\n" + bg.tobytes())
    with open(os.path.join(d, "bg.txt"), "w") as f:
        f.write(os.path.join(d, "bg.pgm") + "\n")
    scene = rng.integers(0, 256, (80, 100)).astype(np.uint8)
    scene[20:52, 30:62] = pos[0]
    out = {}
    for name, trainer in (("port", CascadeTrainer(feature_type=FEATURE_HOG, win_w=32, win_h=32,
                                                  device="cpu")),
                          ("jax", JCascadeTrainer(feature_type=FEATURE_HOG, win_w=32,
                                                  win_h=32))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer.train(os.path.join(d, name), os.path.join(d, "pos.vec"),
                          os.path.join(d, "bg.txt"), num_pos=120, num_neg=100, num_stages=2)
        out[name] = [ln for ln in buf.getvalue().splitlines()  # clock lines dropped
                     if not ln.startswith(("Training until", "Precalculation time"))]
    return d, out, scene


def test_hog_toy_run_matches_original(hog_toy):
    """The 32x32 HOG toy run: the same files, params.xml byte for byte,
    the stages and cascade.xml token for token with the same features,
    leaves and structure, the thresholds within 1e-6 (the responses'
    C.4 difference moves a split threshold's last bits), and the same
    transcript."""
    d, out, _ = hog_toy
    names = sorted(os.listdir(os.path.join(d, "jax")))
    assert names == sorted(os.listdir(os.path.join(d, "port"))) == [
        "cascade.xml", "params.xml", "stage0.xml"]
    for name in names:
        with open(os.path.join(d, "port", name), "rb") as a, \
                open(os.path.join(d, "jax", name), "rb") as b:
            ours, theirs = a.read(), b.read()
        if name == "params.xml":
            assert ours == theirs
        else:
            assert _floats_close(ours, theirs) <= 2, name
    assert out["port"] == out["jax"]
    m = read_cascade_xml(os.path.join(d, "port", "cascade.xml"))
    assert m.feat_size == 36 and m.feature_type == FEATURE_HOG


@pytest.mark.parametrize("min_neighbors", [0, 1])
def test_hog_detector_matches_original(hog_toy, min_neighbors):
    """tests/test_train.py:335's scene (noise with one pasted positive),
    sf 1.2: the port's HOGDetector, built by make_detector, gives the JAX
    HOGDetector's rects, on the JAX trainer's cascade."""
    d, _, scene = hog_toy
    path = os.path.join(d, "jax", "cascade.xml")
    want = JHOGDetector(jread_cascade_xml(path)).detect_multi_scale(scene, 1.2, min_neighbors)
    det = make_detector(read_cascade_xml(path), device="cpu")
    assert isinstance(det, HOGDetector)
    got = det.detect_multi_scale(scene, 1.2, min_neighbors)
    assert len(want) >= 1
    np.testing.assert_array_equal(np.asarray(got, np.int64).reshape(-1, 4),
                                  np.asarray(want, np.int64).reshape(-1, 4))
    assert _build.LAUNCHES["hog_hist"] == _build.LAUNCHES["hog_eval"] == 0  # plain on the CPU


def test_hog_detector_spans(hog_toy, monkeypatch):
    """The HOG detector's phase scopes are spans: with tracing off they
    never synchronize the card; traced, a frame is one detect.frame root
    over its hog.* phases, a resize and a predict a level, counting the
    upload and the fetch as its syncs."""
    d, _, scene = hog_toy
    det = make_detector(read_cascade_xml(os.path.join(d, "port", "cascade.xml")), device="cpu")
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(1))
    want = det.detect_multi_scale(scene, 1.2, 1)
    assert calls == []
    monkeypatch.undo()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = det.detect_multi_scale(scene, 1.2, 1)
    spans = profiling.spans()
    profiling.reset()
    np.testing.assert_array_equal(got, want)
    root = spans[0]
    assert root.name == "detect.frame" and all(x.root == root.id for x in spans)
    names = [x.name for x in spans]
    assert names.count("hog.resize") == names.count("hog.predict") >= 2
    assert {"detect.raw_windows", "hog.plan", "hog.fetch", "hog.map", "hog.group"} <= set(names)
    assert root.counts["sync"] >= 2


@pytest.mark.parametrize("thr", [1, 3])
@pytest.mark.parametrize("n", [250, 4000])
def test_group_rectangles_at_scale_matches_original(n, thr):
    """The grouping (dense up to 256 rects, k-d trees beyond) against
    the JAX package's dense one on a
    pyramid's worth of raw windows: 25 sizes 1.1 apart, positions on each
    level's grid, duplicates and clusters that span neighbouring sizes."""
    rng = np.random.default_rng(n + thr)
    lv = rng.integers(0, 25, n)
    f = 1.1 ** lv
    size = np.rint(24 * f).astype(np.int64)
    step = np.where(f < 2, 2, 1)
    cx, cy = rng.integers(0, max(2, n // 130), n), rng.integers(0, max(2, n // 200), n)
    x = np.rint((cx * 6 + rng.integers(0, 3, n) * step) * f).astype(np.int64)
    y = np.rint((cy * 6 + rng.integers(0, 3, n) * step) * f).astype(np.int64)
    rects = np.stack([x, y, size, size + (lv % 3 == 0)], axis=1)
    rects[: n // 10] = rects[n // 10: n // 5]  # exact duplicates
    got = grouping.group_rectangles(rects, thr)
    want = jgrouping.group_rectangles(rects, thr)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16, 256, 257, 1024])
def test_pair_searches_agree(n):
    """The all-against-all and the k-d pair search give the same pairs on
    detection-like rects on both sides of DENSE_MAX, and similar_pairs
    takes the dense one up to it."""
    rects = detection_like(n, seed=n)
    want = pair_set(grouping.dense_pairs(rects), n)
    np.testing.assert_array_equal(pair_set(grouping.kd_pairs(rects), n), want)
    np.testing.assert_array_equal(pair_set(grouping.similar_pairs(rects), n), want)
    assert len(want) > n  # every rect with itself, and more


def test_hog_edge_cases_on_the_cpu():
    """utils/edges.py's HOG windows run through both entry points on the
    CPU (the plain version twice): the set the card checks."""
    n_cases, bad = hog_edge_mismatches(torch.device("cpu"))
    assert n_cases == 168 and not bad


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n", [(24, 24, 3072), (32, 32, 3072), (16, 20, 7), (60, 200, 3),
                                   (24, 24, 8192), (181, 256, 5), (256, 181, 3)])
def test_hog_kernels_match_plain(cuda_device, h, w, n):
    x = torch.from_numpy(_windows(h, w, n, n + h)).to(cuda_device)
    before = dict(_build.LAUNCHES)
    hist, norm = hog.hog_integral_histogram(x)
    want_h, want_n = hog.hog_integral_histogram(x, impl="ref")
    assert torch.equal(hist, want_h) and torch.equal(norm, want_n)
    cat = hog_catalog(w, h)
    cells = torch.from_numpy(cat.cell_corner_offsets()).to(cuda_device)
    ids = torch.arange(cat.var_count, device=cuda_device)
    flat = (hist.reshape(n, 9, -1), norm.reshape(n, -1))
    got = hog.hog_responses(*flat, cells, ids)
    assert torch.equal(got, hog.hog_responses(*flat, cells, ids, impl="ref"))
    assert _build.LAUNCHES["hog_hist"] == before.get("hog_hist", 0) + 1
    assert _build.LAUNCHES["hog_eval"] == before.get("hog_eval", 0) + 1


@pytest.mark.cuda
def test_hog_kernel_edges(cuda_device):
    n_cases, bad = hog_edge_mismatches(cuda_device)
    assert n_cases == 168 and not bad, bad


@pytest.mark.cuda
def test_hog_eval_lists_match_plain(cuda_device):
    """hog_eval at the detector's batch (8 192 windows at 24x24) on
    hog_id_cases' lists and a few variables of many features, equal to
    the plain version."""
    n = 8192
    x = torch.from_numpy(_windows(24, 24, n, 3)).to(cuda_device)
    hist, norm = hog.hog_integral_histogram(x)
    flat = (hist.reshape(n, 9, -1), norm.reshape(n, -1))
    cat = hog_catalog(24, 24)
    cells = torch.from_numpy(cat.cell_corner_offsets()).to(cuda_device)
    lists = [ids for _, ids in hog_id_cases(cat.var_count, 1)] + [np.array([300, 5, 41, 77, 5])]
    for ids in lists:
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(cuda_device)
        assert torch.equal(hog.hog_responses(*flat, cells, ids),
                           hog.hog_responses(*flat, cells, ids, impl="ref"))


@pytest.mark.cuda
def test_hog_evaluator_on_the_card_matches_the_cpu(cuda_device):
    """The evaluator's blocks and explicit variables on the card (both
    kernels) equal the CPU's plain versions."""
    x = _windows(32, 32, 500, 11)
    ev = HOGTrainEvaluator(hog_catalog(32, 32), block_size=36 * 20, device=cuda_device)
    ev_cpu = HOGTrainEvaluator(hog_catalog(32, 32), block_size=36 * 20, device="cpu")
    ev.set_samples(x)
    ev_cpu.set_samples(x)
    for b in range(ev.num_blocks()):
        assert torch.equal(ev.values_block(b).cpu(), ev_cpu.values_block(b))
    ids = [5, 700, 3, 1295]
    assert torch.equal(ev.values_for_vars(ids).cpu(), ev_cpu.values_for_vars(ids))
