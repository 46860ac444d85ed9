"""DAB, RAB and LB stumps and Haar ALL mining in the port against the JAX
package on the CPU: the two-class ordered split's plain version bit for
bit against _ordered_class_split_block and _block_split_fast (both
criteria, exact ties included), a numpy mirror of the kernel's walk with
the two-class qualities, the stage trainer of every boost type with and
without budgets, the dense miner with tilted features, 12x12 toy runs
whose files and transcript equal the JAX trainer's, what still raises,
and (cuda-marked) the kernel's two-class policy against its plain
version on the card."""

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

from cascadeclassifier_tpu.data.negreader import NegReader as JNegReader  # noqa: E402
from cascadeclassifier_tpu.ops.features import haar_catalog as jhaar_catalog  # noqa: E402
from cascadeclassifier_tpu.train import boost as jboost  # noqa: E402
from cascadeclassifier_tpu.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator as JHaarTrainEvaluator,
)
from cascadeclassifier_tpu.train.predictor import CascadePredictor as JPredictor  # noqa: E402
from cascadeclassifier_tpu.train.trainer import CascadeTrainer as JCascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.convert import stages_from_jax  # noqa: E402
from cascadeclassifier_tpu_torch.data.negreader import NegReader  # noqa: E402
from cascadeclassifier_tpu_torch.data.vec import write_vec  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import (  # noqa: E402
    BOOST_DAB,
    BOOST_GAB,
    BOOST_LB,
    BOOST_RAB,
    FEATURE_HAAR,
    FEATURE_HOG,
    Stage,
    WeakTree,
)
from cascadeclassifier_tpu_torch.ops.features import haar_catalog  # noqa: E402
from cascadeclassifier_tpu_torch.parallel.sharded import make_mesh  # noqa: E402
from cascadeclassifier_tpu_torch.train import boost, split  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator  # noqa: E402
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor  # noqa: E402
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402

from .test_torch_train_split import TIE_CASES, _block, _kernel_in_numpy, _tie_block  # noqa: E402
from .test_torch_train_stage import _assert_stages_equal, _samples, _train_both  # noqa: E402

BOOSTS = {"DAB": BOOST_DAB, "RAB": BOOST_RAB, "LB": BOOST_LB, "GAB": BOOST_GAB}


def _class_inputs(v, w, resp, mask):
    """The two-class split's sorted (N, B) inputs of a (B, N) block (class
    1 where resp > 0), its totals as the trainer sums them, and the JAX
    package's arguments."""
    cls = (resp > 0).astype(np.int32)
    si = np.argsort(v, axis=1, kind="stable")
    wm = np.where(mask, w, 0.0)
    w0, w1 = np.where(cls == 0, wm, 0.0), np.where(cls == 1, wm, 0.0)
    t0 = split.tree_sum(w0)
    t1 = split.tree_sum(wm) - t0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    arrays = (t(np.take_along_axis(v, si, 1)), t(w0[si]), t(w1[si]), t(mask[si]), t0, t1)
    return arrays, cls, si


# the shapes of test_torch_train_split.py; Gini from 9 samples up
# (split.gini_l1_first), with n > 256 both multiples of 16 and not
CLASS_SHAPES = [(7, 9), (7, 16), (33, 17), (40, 40), (64, 300), (128, 1000), (16, 3072),
                (24, 257), (24, 512)]


@pytest.mark.parametrize("use_gini", [False, True])
@pytest.mark.parametrize("b,n", CLASS_SHAPES)
def test_class_plain_matches_ordered_class_split_block(b, n, use_gini):
    v, w, resp, mask = _block(b, n, b * n + 3)
    arrays, cls, si = _class_inputs(v, w, resp, mask)
    with jax.enable_x64(True):
        q, thr = jboost._ordered_class_split_block(
            jnp.asarray(v), jnp.asarray(si.astype(np.int32)), jboost.as_f64(w), jnp.asarray(cls),
            jnp.asarray(mask), use_gini)
    gq, gthr = split.split_scan_class_ref(*arrays, use_gini)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gthr.numpy(), np.asarray(thr))
    assert np.isfinite(np.asarray(q)).sum() >= b - 1


@pytest.mark.parametrize("use_gini", [False, True])
@pytest.mark.parametrize("b,n,wthr", [(32, 300, -np.inf), (32, 512, 4e-4), (48, 1024, 1e-3)])
def test_class_gather_plain_matches_block_split_fast(b, n, wthr, use_gini):
    """At a tree root (mask = valid & (w >= wthr)) the gathered two-class
    form gives _block_split_fast's block result (classifier=True)."""
    v, w, resp, _ = _block(b, n, 5 * n)
    valid = np.ones(n, bool)
    valid[-9:] = False  # padding
    w = np.where(valid, w, 0.0)
    mask = valid & (w >= wthr)
    cls = (resp > 0).astype(np.int32)
    si = np.argsort(v, axis=1, kind="stable")
    vs = np.take_along_axis(v, si, 1)
    wm = np.where(mask, w, 0.0)
    w0, w1 = np.where(cls == 0, wm, 0.0), np.where(cls == 1, wm, 0.0)
    t0 = split.tree_sum(w0)
    gq, gthr = split.split_scan_class_gather(
        torch.from_numpy(vs).t(), torch.from_numpy(si).t(), torch.from_numpy(w0),
        torch.from_numpy(w1), torch.from_numpy(mask), t0, split.tree_sum(wm) - t0, use_gini)
    with jax.enable_x64(True):
        qm, i, thr_i = jboost._block_split_fast(
            jnp.asarray(v), jnp.asarray(vs), jnp.asarray(valid[si]),
            jnp.asarray(cls.astype(np.int8)[si]), jboost.as_f64(w), jboost.as_f64(w),
            jnp.asarray(cls), jnp.asarray(valid), jboost.as_f64(wthr),
            classifier=True, use_gini=use_gini, resp_static=True)
    gi = int(np.flatnonzero(gq.numpy() == gq.numpy().max())[0])
    assert gq.numpy().max() == float(qm) and gi == int(i) and gthr.numpy()[gi] == float(thr_i)


@pytest.mark.parametrize("use_gini", [False, True])
@pytest.mark.parametrize("b,n,npos,span,masked", TIE_CASES)
def test_class_plain_first_maximum_on_exact_ties(b, n, npos, span, masked, use_gini):
    """Exact ties of the two-class qualities (dyadic weights, zero-weight
    spans): the first tied position wins, as in the JAX package."""
    v, w, resp, mask = _tie_block(b, n, npos, span, n + span, masked)
    arrays, cls, si = _class_inputs(v, w, resp, mask)
    with jax.enable_x64(True):
        q, thr = jboost._ordered_class_split_block(
            jnp.asarray(v), jnp.asarray(si.astype(np.int32)), jboost.as_f64(w), jnp.asarray(cls),
            jnp.asarray(mask), use_gini)
    gq, gthr = split.split_scan_class_ref(*arrays, use_gini)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gthr.numpy(), np.asarray(thr))


@pytest.mark.parametrize("policy", ["misclass", "gini"])
@pytest.mark.parametrize("b,n", [(6, 9), (5, 300), (3, 4200), (17, 16), (3, 17), (3, 256),
                                 (3, 257), (2, 4097)])
def test_kernel_walk_in_numpy_matches_class_plain(b, n, policy):
    """csrc/split_scan.cu's decomposition (which ran the two-class policy
    before csrc/split_class.cu; test_torch_split_class.py replays that
    kernel) with the two-class qualities equals the plain version."""
    v, w, resp, mask = _block(b, n, 3 * n + b + 1)
    arrays, _cls, _si = _class_inputs(v, w, resp, mask)
    vs, w0s, w1s, kept, t0, t1 = arrays
    q, thr = _kernel_in_numpy(vs.numpy(), w0s.numpy(), w1s.numpy(), kept.numpy(), t0, t1, policy)
    gq, gthr = split.split_scan_class_ref(*arrays, policy == "gini")
    np.testing.assert_array_equal(q, gq.numpy())
    np.testing.assert_array_equal(thr, gthr.numpy())


def test_gini_contraction_follows_the_sample_count():
    assert [split.gini_l1_first(n) for n in (9, 16, 255, 256, 257, 272, 300, 512, 1000)] == [
        False, False, False, False, True, False, True, False, True]


@pytest.mark.parametrize("budget", ["none", "evict"])
@pytest.mark.parametrize("boost_type", ["DAB", "RAB", "LB"])
def test_stage_trainer_boost_types_match_original(boost_type, budget):
    """A stage of each boost type: trees, leaves (DAB's scaled by C), the
    stage threshold and the per-sample sums, with every block resident
    and with budgets that evict value and index blocks."""
    samples, labels, valid = _samples(pad=26)
    n = len(samples)
    block = 1024
    per_val, per_idx = 4 * n * block / 2**20, 17 * n * block / 2**20
    val_mb, idx_mb = {"none": (None, None), "evict": (2.5 * per_val, 1.5 * per_idx)}[budget]
    params = boost.BoostParams(boost_type=BOOSTS[boost_type], weak_count=8, max_false_alarm=0.05)
    _ev, (s, sums), (js, jsums) = _train_both(samples, labels, valid, params, block, val_mb,
                                              idx_mb)
    assert len(s.trees) >= 3
    _assert_stages_equal(s, js)
    np.testing.assert_array_equal(sums, jsums)


def test_node_value_class_matches_original():
    rng = np.random.default_rng(4)
    w = rng.random(300) ** 2
    cls = rng.integers(0, 2, 300)
    for mask in (rng.random(300) > 0.3, np.zeros(300, bool), cls == 1):
        for bt in (BOOST_DAB, BOOST_RAB):
            assert boost._node_value_class(w, cls, mask, bt) == jboost._node_value_class(
                w, cls, mask, bt)
    assert boost._log_ratio(0.0) == jboost._log_ratio(0.0)


def _tilted_stages(ev, rng):
    """Two stages of stumps over tilted and upright Haar ALL features
    (global indices), thresholds at quantiles of their values on random
    windows, each stage passing about half of them."""
    win = rng.integers(0, 256, (400, 12, 12)).astype(np.uint8)
    ev.set_samples(win)
    tilted = np.flatnonzero(ev.catalog.tilted)
    stages = []
    for s in range(2):
        ids = np.concatenate([rng.choice(tilted, 5, replace=False),
                              rng.choice(np.flatnonzero(~ev.catalog.tilted), 1)])
        vals = ev.values_for_vars(ids).numpy()
        trees = []
        for k, f in enumerate(ids):
            thr = np.float32(np.quantile(vals[k], 0.3 + 0.1 * k))
            trees.append(WeakTree(left=np.array([0], np.int32), right=np.array([-1], np.int32),
                                  feature_idx=np.array([f], np.int32),
                                  threshold=np.array([thr], np.float32),
                                  leaf_values=np.array([-0.5 - 0.1 * k, 0.7], np.float32)))
        sums = sum(np.where(vals[k] <= t.threshold[0], t.leaf_values[0], t.leaf_values[1])
                   .astype(np.float64) for k, t in enumerate(trees))
        stages.append(Stage(threshold=float(np.quantile(sums, 0.4 + 0.2 * s)), trees=trees))
    return stages


@pytest.mark.parametrize("lazy", [False, True])
def test_predict_levels_tilted_matches_original(tmp_path, lazy):
    """Mining with tilted features (the miner's upright + tilted product):
    the masks of the JAX package's miner, eager and lazy levels."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(12)
    names = []
    for i, (h, w) in enumerate(((90, 120), (75, 64))):
        img = rng.integers(0, 200, (h, w)).astype(np.uint8)
        img[10:40, 10:40] = 170
        p = str(tmp_path / f"bg{i}.png")
        cv2.imwrite(p, img)
        names.append(p)
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "ALL"), device="cpu")
    stages = _tilted_stages(ev, rng)
    ours_reader, their_reader = NegReader(bg, 12, 12, lazy=lazy), JNegReader(bg, 12, 12, lazy=lazy)
    levels, jlevels = [], []
    for _ in range(25):
        for rd, out in ((ours_reader, levels), (their_reader, jlevels)):
            img, pos = rd.level_positions()
            out.append((img, pos, (rd.last, float(rd.scale))))
            rd.skip(len(pos) - 1 if len(out) % 3 == 0 else len(pos))
    jp = JPredictor(lambda: JHaarTrainEvaluator(jhaar_catalog(12, 12, "ALL")), stages)
    ours = CascadePredictor(lambda: ev, stages_from_jax(stages))
    got, want = ours.predict_levels(levels, 12, 12), jp.predict_levels(jlevels, 12, 12)
    flat = np.concatenate(got)
    assert 0 < flat.sum() < len(flat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    win = rng.integers(0, 200, (300, 12, 12)).astype(np.uint8)
    np.testing.assert_array_equal(ours.predict_batch(win), jp.predict_batch(win))


def diag_data(d, seed=1):
    """120 positives (noise with a bright anti-diagonal line, jittered by a
    pixel) and one 120x160 PGM background of noise with such lines three
    to five pixels off at 60 % of a 6-pixel grid: hard negatives, several
    trees a stage, and a tilted feature in the ALL cascade."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:12, 0:12]

    def windows(n, offsets):
        x = rng.integers(0, 140, (n, 12, 12)).astype(np.uint8)
        for i in range(n):
            band = np.abs(yy + xx - 11 - rng.choice(offsets)) <= 1
            x[i][band] = rng.integers(150, 256, band.sum())
        return x

    write_vec(os.path.join(d, "pos.vec"), windows(120, [-1, 0, 1]))
    h, w = 120, 160
    bg = rng.integers(0, 140, (h, w)).astype(np.uint8)
    for y0 in range(0, h - 12, 6):
        for x0 in range(0, w - 12, 6):
            if rng.random() < 0.6:
                bg[y0:y0 + 12, x0:x0 + 12] = windows(1, [-5, -4, -3, 3, 4, 5])[0]
    with open(os.path.join(d, "bg.pgm"), "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h) + bg.tobytes())
    with open(os.path.join(d, "bg.txt"), "w") as f:
        f.write(os.path.join(d, "bg.pgm") + "\n")


def run_toy(trainer, d, out, num_stages=3):
    """Train on diag_data's files → (model, transcript without the clock
    lines: the elapsed time and the precalculation seconds)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model = trainer.train(os.path.join(d, out), os.path.join(d, "pos.vec"),
                              os.path.join(d, "bg.txt"), num_pos=100, num_neg=80,
                              num_stages=num_stages)
    lines = [ln for ln in buf.getvalue().splitlines()
             if not ln.startswith(("Training until", "Precalculation time"))]
    return model, lines


def toy_both(d, feature_type, haar_mode, params):
    """The port's and the JAX trainer's toy runs on the same files."""
    ours = run_toy(CascadeTrainer(feature_type=feature_type, win_w=12, win_h=12,
                                  haar_mode=haar_mode, boost=params, device="cpu"), d, "port")
    theirs = run_toy(JCascadeTrainer(feature_type=feature_type, win_w=12, win_h=12,
                                     haar_mode=haar_mode,
                                     boost=jboost.BoostParams(**dataclasses.asdict(params))),
                     d, "jax")
    return ours, theirs


def assert_same_run(d, ours, theirs):
    names = sorted(os.listdir(os.path.join(d, "jax")))
    assert names == sorted(os.listdir(os.path.join(d, "port")))
    for name in names:
        with open(os.path.join(d, "port", name), "rb") as a, \
                open(os.path.join(d, "jax", name), "rb") as b:
            assert a.read() == b.read(), name
    assert ours[1] == theirs[1]


# ALL: stage 1 takes a tilted feature, and stage 2 mines through it
TOY_RUNS = {"ALL-GAB": ("ALL", BOOST_GAB, 0.3, 8), "DAB": ("BASIC", BOOST_DAB, 0.05, 6),
            "RAB": ("BASIC", BOOST_RAB, 0.05, 6), "LB": ("BASIC", BOOST_LB, 0.05, 6)}


@pytest.mark.parametrize("run", sorted(TOY_RUNS))
def test_toy_run_matches_original(tmp_path, run):
    mode, bt, mfa, wc = TOY_RUNS[run]
    d = str(tmp_path)
    diag_data(d)
    params = boost.BoostParams(boost_type=bt, max_false_alarm=mfa, weak_count=wc)
    ours, theirs = toy_both(d, FEATURE_HAAR, mode, params)
    assert_same_run(d, ours, theirs)
    model = ours[0]
    assert model.num_stages >= 2 and sum(len(s.trees) for s in model.stages) >= 4
    assert "===== TRAINING 2-stage =====" in ours[1]
    if mode == "ALL":
        assert any(f.tilted for f in model.features)


@pytest.mark.parametrize("what", ["depth2", "mesh", "HOG"])
def test_still_unported_options_raise(what):
    """Deep trees, HOG and a FeatureMesh are ported and build; a mesh of
    another type raises TypeError."""
    kw = {"depth2": dict(boost=boost.BoostParams(max_depth=2)),
          "mesh": dict(mesh=make_mesh(2, devices=["cpu"] * 2)),
          "HOG": dict(feature_type=FEATURE_HOG)}[what]
    trainer = CascadeTrainer(device="cpu", **kw)
    assert getattr(trainer.evaluator, "featSize", 1) == (36 if what == "HOG" else 1)
    if what == "mesh":
        assert trainer.mesh.local_shards == [0, 1]
        with pytest.raises(TypeError):
            CascadeTrainer(device="cpu", mesh=object())


def test_class_split_calls_go_through_the_wrapper(monkeypatch):
    samples, labels, valid = _samples()
    ev = HaarTrainEvaluator(haar_catalog(12, 12, "BASIC"), block_size=2048, device="cpu")
    ev.set_samples(samples)
    calls = []
    real = boost.split_scan_class_gather

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(boost, "split_scan_class_gather", spy)
    stage, _ = boost.StageTrainer(ev, boost.BoostParams(boost_type=BOOST_RAB,
                                                        weak_count=3)).train(
        labels, valid=valid, verbose=False)
    assert len(calls) == ev.num_blocks() * len(stage.trees) and all(calls)
    assert _build.LAUNCHES["split_scan_class_gather"] == 0  # the CPU takes the plain version


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_gini", [False, True])
@pytest.mark.parametrize("b,n,mask_frac", [(130, 17, 0.2), (257, 3072, 0.3), (64, 70000, 0.1),
                                           (33, 300, 1.0), (31264, 1000, 0.2)])
def test_split_scan_class_kernel_matches_plain(cuda_device, b, n, mask_frac, use_gini):
    """Both load policies of the tables (shared memory, and global memory
    at 70 000 samples), both layouts of the sort order."""
    v, w, resp, mask = _block(b, n, b + n, mask_frac)
    cls = resp > 0
    si = np.argsort(v, axis=1, kind="stable")
    vs = torch.from_numpy(np.take_along_axis(v, si, 1))
    order = torch.from_numpy(si)
    wm = np.where(mask, w, 0.0)
    w0, w1 = torch.from_numpy(np.where(cls, 0.0, wm)), torch.from_numpy(np.where(cls, wm, 0.0))
    t0 = split.tree_sum(w0.numpy())
    t1 = split.tree_sum(wm) - t0
    mk = torch.from_numpy(mask)
    want = split.split_scan_class_gather(vs.t(), order.t(), w0, w1, mk, t0, t1, use_gini)
    for layout in ("fresh", "resident"):
        a, o = (vs.t(), order.t()) if layout == "fresh" else (vs.t().contiguous(),
                                                              order.t().contiguous())
        before = _build.LAUNCHES["split_scan_class_gather"]
        got = split.split_scan_class_gather(a.to(cuda_device), o.to(cuda_device),
                                            w0.to(cuda_device), w1.to(cuda_device),
                                            mk.to(cuda_device), t0, t1, use_gini)
        assert _build.LAUNCHES["split_scan_class_gather"] == before + 1
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
