"""The training path's building blocks against the JAX package on the
CPU: Haar catalogs, f32 responses and norm factors (and the reference
goldens), sample integrals, the INTER_LINEAR_EXACT mining levels, the
negative reader's schedule and its numpy image reader, and .vec I/O."""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cascadeclassifier_tpu.data import negreader as jnegreader  # noqa: E402
from cascadeclassifier_tpu.data import vec as jvec  # noqa: E402
from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.ops import integral as jintegral  # noqa: E402
from cascadeclassifier_tpu.ops import resize as jresize  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu_torch.data import negreader, vec  # noqa: E402
from cascadeclassifier_tpu_torch.ops import features, integral, resize  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name), "rt") as f:
        return f.read().split("\n")


def _golden_imgs(mode):
    v = np.array([int(x) for line in _golden(f"img_haar_12x10_{mode}.txt.gz")
                  for x in line.split()], np.int32)
    return v.reshape(4, 10, 12).astype(np.uint8)


@pytest.mark.parametrize("mode", ["BASIC", "CORE", "ALL"])
def test_haar_catalog_matches_original(mode):
    ours, theirs = features.haar_catalog(12, 10, mode), jfeatures.haar_catalog(12, 10, mode)
    for f in ("rects", "weights", "tilted"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    np.testing.assert_array_equal(ours.corner_offsets(), theirs.corner_offsets())
    count = int(_golden(f"geom_haar_12x10_{mode}.txt.gz")[0].split()[1])
    assert len(ours) == count
    assert features.haar_mode_id(mode) == jfeatures.haar_mode_id(mode)


def test_haar_catalog_24x24_basic_count():
    assert len(features.haar_catalog(24, 24, "BASIC")) == 162_336


@pytest.mark.parametrize("mode", ["BASIC", "CORE", "ALL"])
def test_responses_and_norm_factors_match_original_and_golden(mode):
    """f32 responses and nf bitwise against the JAX evaluator, within the
    reference goldens' tolerance of tests/test_features.py."""
    imgs = _golden_imgs(mode)
    cat = features.haar_catalog(12, 10, mode)
    ours = HaarTrainEvaluator(cat, block_size=97, device="cpu")
    theirs = JHaarTrainEvaluator(jfeatures.haar_catalog(12, 10, mode), block_size=97)
    ours.set_samples(imgs)
    theirs.set_samples(imgs)
    np.testing.assert_array_equal(ours.nf.numpy(), np.asarray(theirs.nf))
    got = torch.cat([ours.values_block(b) for b in range(ours.num_blocks())]).numpy()
    want = np.concatenate([np.asarray(theirs.values_block(b)) for b in range(theirs.num_blocks())])
    np.testing.assert_array_equal(got, want)
    ids = [0, 5, len(cat) - 1, 17, 17]
    np.testing.assert_array_equal(ours.values_for_vars(ids).numpy(),
                                  np.asarray(theirs.values_for_vars(ids)))
    lines = [line for line in _golden(f"resp_haar_12x10_{mode}.txt.gz") if line]
    ref = np.array(lines[1:], np.float64).reshape(4, len(cat))
    np.testing.assert_allclose(got.T, ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["BASIC", "ALL"])
def test_eval_haar_matches_original(mode):
    imgs = _golden_imgs(mode)
    cat = features.haar_catalog(12, 10, mode)
    x = torch.from_numpy(imgs)
    s = integral.integral_image(x)
    nf = integral.window_norm_factor(s, integral.integral_sq(x, dtype=torch.int32))
    tilt = integral.integral_tilted(x).reshape(4, -1) if mode == "ALL" else None
    got = features.eval_haar(s.reshape(4, -1), tilt, nf, torch.from_numpy(cat.corner_offsets()),
                             torch.from_numpy(cat.weights),
                             torch.from_numpy(cat.tilted) if mode == "ALL" else None)
    js = jintegral.integral_image(jnp.asarray(imgs))
    jnf = jintegral.window_norm_factor(js, jintegral.integral_sq(jnp.asarray(imgs), jnp.int32))
    jt = jintegral.integral_tilted(jnp.asarray(imgs)).reshape(4, -1) if mode == "ALL" else None
    want = jfeatures.eval_haar(js.reshape(4, -1), jt, jnf, jnp.asarray(cat.corner_offsets()),
                               jnp.asarray(cat.weights),
                               jnp.asarray(cat.tilted) if mode == "ALL" else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(3, 10, 12), (2, 24, 24), (1, 1, 1), (4, 5, 31)])
def test_sample_integrals_match_original(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape).astype(np.uint8)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(integral.integral_image(xt).numpy(),
                                  np.asarray(jintegral.integral_image(xj)))
    np.testing.assert_array_equal(integral.integral_sq(xt, torch.int32).numpy(),
                                  np.asarray(jintegral.integral_sq(xj, jnp.int32)))
    np.testing.assert_array_equal(integral.integral_tilted(xt).numpy(),
                                  np.asarray(jintegral.integral_tilted(xj)))
    if shape[1] >= 3 and shape[2] >= 3:
        s, sq = integral.integral_image(xt), integral.integral_sq(xt)
        js, jsq = jintegral.integral_image(xj), jintegral.integral_sq(xj, jnp.int32)
        np.testing.assert_array_equal(integral.window_norm_factor(s, sq).numpy(),
                                      np.asarray(jintegral.window_norm_factor(js, jsq)))


@pytest.mark.parametrize("sw,sh,dw,dh", [(640, 480, 581, 436), (24, 24, 17, 17),
                                         (33, 17, 20, 11), (7, 7, 13, 19), (1, 1, 5, 5)])
def test_resize_np_matches_original_and_cv2(sw, sh, dw, dh):
    rng = np.random.default_rng(sw * 7 + dh)
    src = rng.integers(0, 256, (sh, sw)).astype(np.uint8)
    got = resize.resize_linear_exact_np(src, dw, dh)
    np.testing.assert_array_equal(got, jresize.resize_linear_exact_np(src, dw, dh))
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(
        got, cv2.resize(src, (dw, dh), interpolation=cv2.INTER_LINEAR_EXACT))


def test_axis_tab_dev_matches_host_tables():
    for ssz in (1, 2, 3, 24, 97, 1080, 1920):
        for dsz in (1, 2, 17, 333, 1081):
            sx_h, c_h = resize._axis_tab(ssz, dsz)
            sx_d, sx1_d, c_d = (t.numpy() for t in resize._axis_tab_dev(ssz, ssz, dsz, 0, dsz,
                                                                        "cpu"))
            np.testing.assert_array_equal(sx_d, sx_h)
            np.testing.assert_array_equal(c_d, c_h)
            np.testing.assert_array_equal(sx1_d, np.minimum(sx_h + 1, ssz - 1))


def test_build_level_stack_matches_original():
    """The cases of tests/test_resize.py's build-level test, against the
    JAX package's build_level_stack and the host resize."""
    rng = np.random.default_rng(11)
    hp, wp = 96, 192
    cases = [(100, 140, 71, 99, 5, 3), (60, 80, 120, 160, 0, 0), (97, 131, 97, 131, 13, 7),
             (40, 60, 30, 45, 2, 40)]
    src = np.zeros((len(cases), 128, 160), np.uint8)
    params = np.zeros((6, len(cases)), np.int32)
    for i, (sh, sw, dh, dw, oy, ox) in enumerate(cases):
        src[i, :sh, :sw] = rng.integers(0, 256, (sh, sw), np.uint8)
        params[:, i] = (sh, sw, dh, dw, oy, ox)
    got = resize.build_level_stack(torch.from_numpy(src), torch.from_numpy(params), hp, wp)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jresize.build_level_stack(src, params, hp=hp, wp=wp)))
    for i, (sh, sw, dh, dw, oy, ox) in enumerate(cases):
        full = resize.resize_linear_exact_np(src[i, :sh, :sw], dw, dh)[oy:oy + hp, ox:ox + wp]
        np.testing.assert_array_equal(got[i, :full.shape[0], :full.shape[1]].numpy(), full)


def _backgrounds(tmp_path, sizes=((80, 100), (64, 72), (150, 97)), ext="pgm"):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    names = []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        p = str(tmp_path / f"bg{i}.{ext}")
        cv2.imwrite(p, img)
        names.append(p)
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write("# a comment\n" + "\n".join(names) + "\n\nnot-listed.png\n")
    return bg


@pytest.mark.parametrize("lazy", [False, True])
def test_negreader_schedule_matches_original(tmp_path, lazy):
    """get(), level_positions(), skip() and state() walk the same window
    schedule, window for window, as the JAX package's reader."""
    bg = _backgrounds(tmp_path)
    assert negreader.read_bg_list(bg) == jnegreader.read_bg_list(bg)
    ours = negreader.NegReader(bg, 24, 24, lazy=lazy)
    theirs = jnegreader.NegReader(bg, 24, 24, lazy=lazy)
    np.testing.assert_array_equal(ours.take_batch(37), theirs.take_batch(37))
    for step in (1, 5, 40, 300, 2):
        img, pos = ours.level_positions()
        jimg, jpos = theirs.level_positions()
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(np.asarray(img), np.asarray(jimg))
        assert ours.skip(step) == theirs.skip(step)
        assert ours.point == theirs.point and ours.scale == theirs.scale
        assert (ours.last, ours.round) == (theirs.last, theirs.round)
    st = ours.state()
    a = ours.take_batch(9)
    ours.set_state(st)
    np.testing.assert_array_equal(ours.take_batch(9), a)
    np.testing.assert_array_equal(a, theirs.take_batch(9))


@pytest.mark.parametrize("ext", ["png", "pgm"])
def test_imread_gray_matches_cv2(tmp_path, ext):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(1, 1), (5, 7), (64, 80), (120, 333)]):
        for kind in range(3):
            if kind == 0:
                img = rng.integers(0, 256, (h, w))
            elif kind == 1:
                img = (np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 5) % 256
            else:
                img = np.kron(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1)), np.ones((4, 4)))
            img = img[:h, :w].astype(np.uint8)
            p = str(tmp_path / f"{i}_{kind}.{ext}")
            cv2.imwrite(p, img)
            np.testing.assert_array_equal(negreader.imread_gray(p), cv2.imread(p, 0))
    assert negreader.imread_gray(str(tmp_path / "missing.png")) is None


def test_imread_gray_pgm_comments_and_no_cv2(tmp_path, monkeypatch):
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5\n# made by hand\n4 3\n# another\n255\n" + img.tobytes())
    np.testing.assert_array_equal(negreader.imread_gray(str(p)), img)
    q = tmp_path / "x.bmp"
    q.write_bytes(b"BM not an image")
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="without cv2"):
        negreader.imread_gray(str(q))


def test_vec_round_trip_matches_original(tmp_path):
    rng = np.random.default_rng(0)
    s = rng.integers(0, 256, (13, 10, 12)).astype(np.uint8)
    ours, theirs = str(tmp_path / "a.vec"), str(tmp_path / "b.vec")
    vec.write_vec(ours, s)
    jvec.write_vec(theirs, s)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(vec.read_vec(ours, 12, 10), s)
    np.testing.assert_array_equal(vec.read_vec(ours), jvec.read_vec(ours))
    pr = vec.PosReader(ours, 12, 10)
    np.testing.assert_array_equal(pr.take(5), s[:5])
    pr.unread(2)
    np.testing.assert_array_equal(pr.get(), s[3])
    pr.take(100)
    with pytest.raises(vec.VecError):
        pr.take(1)
    pr.restart()
    assert pr.remaining == 13
    with pytest.raises(vec.VecError):
        vec.read_vec(ours, 10, 10)


def test_timed_collects_each_scope():
    from cascadeclassifier_tpu_torch.utils import profiling

    profiling.reset_timings()
    for _ in range(3):
        with profiling.timed("a"):
            pass
    with pytest.raises(ValueError):
        with profiling.timed("b"):
            raise ValueError
    t = profiling.timings()
    assert sorted(t) == ["a", "b"] and len(t["a"]) == 3 and all(x >= 0 for x in t["a"])
    profiling.reset_timings()
    assert profiling.timings() == {}


def test_responses_at_75x32_match_original():
    """At 75x32 (the barcode transcripts' window) a product's partial sums
    may pass 2^24, where the order of the f32 adds could show; on bright
    windows, over the 2 000 largest features and 20 000 others, the
    port's values on the CPU equal the JAX package's."""
    cat, jcat = features.haar_catalog(75, 32, "BASIC"), jfeatures.haar_catalog(75, 32, "BASIC")
    rng = np.random.default_rng(0)
    x = rng.integers(200, 256, (64, 32, 75)).astype(np.uint8)
    area = cat.rects[:, 0, 2] * cat.rects[:, 0, 3]
    ids = np.unique(np.concatenate([np.argsort(-area, kind="stable")[:2000],
                                    rng.choice(len(cat), 20000, replace=False)]))
    ours, theirs = HaarTrainEvaluator(cat, device="cpu"), JHaarTrainEvaluator(jcat)
    ours.set_samples(x)
    theirs.set_samples(x)
    np.testing.assert_array_equal(ours.values_for_vars(ids).numpy(),
                                  np.asarray(theirs.values_for_vars(ids)))
