"""The port's multi-device training (cascadeclassifier_tpu_torch/parallel/)
against the JAX package's on the CPU: in-process meshes of ["cpu"] * 8
(the counterpart of conftest's 8 virtual JAX devices) and of 3 shards, and
meshes of two processes joined by gloo. Mirrors tests/test_parallel.py."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from cascadeclassifier_tpu.ops import features as jfeatures  # noqa: E402
from cascadeclassifier_tpu.parallel import sharded as jsharded  # noqa: E402
from cascadeclassifier_tpu.train import boost as jboost  # noqa: E402
from cascadeclassifier_tpu.train import evaluators as jevaluators  # noqa: E402
from cascadeclassifier_tpu_torch.data.vec import write_vec  # noqa: E402
from cascadeclassifier_tpu_torch.models.model import BOOST_DAB  # noqa: E402
from cascadeclassifier_tpu_torch.ops.features import (  # noqa: E402
    haar_catalog,
    hog_catalog,
    lbp_catalog,
)
from cascadeclassifier_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip,
    dryrun_problem,
    split_problem,
)
from cascadeclassifier_tpu_torch.parallel.sharded import (  # noqa: E402
    make_mesh,
    shard_features,
    sharded_batch_eval,
    sharded_ordered_best_split,
)
from cascadeclassifier_tpu_torch.train import boost  # noqa: E402
from cascadeclassifier_tpu_torch.train.evaluators import (  # noqa: E402
    HaarTrainEvaluator,
    HOGTrainEvaluator,
    LBPTrainEvaluator,
)
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer  # noqa: E402
from cascadeclassifier_tpu_torch.utils.train_data import write_pgm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


def cpu_mesh(n, axis="feat"):
    return make_mesh(n, axis=axis, devices=["cpu"] * n)


def jax_best_split(values, sort_idx, w, resp, mask):
    """The JAX package's one-device split search: (quality, var, threshold)."""
    q, thr = jboost._ordered_split_block(jnp.asarray(values), jnp.asarray(sort_idx),
                                         jboost.as_f64(w), jboost.as_f64(resp),
                                         jnp.asarray(mask))
    q, thr = np.asarray(q), np.asarray(thr)
    var = int(np.argmax(q))
    return float(q[var]), var, np.float32(thr[var])


def test_sharded_split_matches_single_device():
    """The seed-0 64x96 problem on 8 shards: the JAX one-device argmax and
    the JAX split sharded over 8 devices, bit for bit (tolerance 0)."""
    values, sort_idx, w, resp, mask = split_problem()
    want = jax_best_split(values, sort_idx.astype(np.int32), w, resp, mask)
    jmesh = jsharded.make_mesh(8)
    jvs, jsi = jsharded.shard_features(jmesh, values, sort_idx.astype(np.int32))
    jq, jvar, jthr = jax.device_get(jsharded.sharded_ordered_best_split(jmesh)(
        jvs, jsi, jboost.as_f64(w), jboost.as_f64(resp), jnp.asarray(mask)))
    mesh = cpu_mesh(8)
    vs, si = shard_features(mesh, values, sort_idx)
    got = sharded_ordered_best_split(mesh)(vs, si, w, resp, mask)
    assert got == want
    assert got == (float(jq), int(jvar), np.float32(jthr))
    assert isinstance(got[2], np.float32)


def test_sharded_split_ties_go_to_the_lowest_index():
    """Every feature the same row: every quality ties, and the combine takes
    global feature 0 from shard 0, as the unsharded first argmax does."""
    values, sort_idx, w, resp, mask = split_problem()
    values[:] = values[5]
    sort_idx[:] = sort_idx[5]
    mesh = cpu_mesh(3)  # 64 rows in shards of 22: 2 padding rows
    vs, si = shard_features(mesh, values, sort_idx)
    q, var, thr = sharded_ordered_best_split(mesh)(vs, si, w, resp, mask)
    assert np.isfinite(q) and var == 0
    assert (q, var, thr) == jax_best_split(values, sort_idx.astype(np.int32), w, resp, mask)


def test_sharded_batch_eval_allreduce():
    """Samples over 8 shards against the JAX sharded_batch_eval, within
    tests/test_parallel.py's rtol 1e-4 (f32 products added in other
    orders; near-zero sums differ relatively by up to 7.9e-5 here, 4.6e-6
    absolute); and both within the f32 dot product's error bound of the
    f64 product, γ_n·|C||R|ᵀ with γ_n = n·2^-24/(1 − n·2^-24), n = 128."""
    rng = np.random.default_rng(1)
    p_len, b = 128, 64
    corner_m = rng.normal(size=(32, p_len)).astype(np.float32)
    sum_rows = rng.normal(size=(b, p_len)).astype(np.float32)
    wts = np.full(b, 1.0 / b, np.float32)
    jmesh = jsharded.make_mesh(8, axis="data")
    sr = jax.device_put(sum_rows, NamedSharding(jmesh, PartitionSpec("data", None)))
    wv = jax.device_put(wts, NamedSharding(jmesh, PartitionSpec("data")))
    jvals, jwsum = jax.device_get(jsharded.sharded_batch_eval(jmesh)(jnp.asarray(corner_m), sr,
                                                                      wv))
    mesh = cpu_mesh(8, axis="data")
    rows, _ = shard_features(mesh, sum_rows)
    w_sh, _ = shard_features(mesh, wts)
    vals, wsum = sharded_batch_eval(mesh)(corner_m, rows, w_sh)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-4)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jwsum), rtol=1e-4)
    exact = corner_m.astype(np.float64) @ sum_rows.T.astype(np.float64)
    u = p_len * 2.0**-24
    err_bound = u / (1 - u) * (np.abs(corner_m).astype(np.float64) @ np.abs(sum_rows).T)
    assert (np.abs(vals.numpy() - exact) <= err_bound).all()
    assert (np.abs(np.asarray(jvals) - exact) <= err_bound).all()
    np.testing.assert_allclose(wsum.numpy(), corner_m @ sum_rows.T @ wts, rtol=1e-4)
    with pytest.raises(ValueError, match="axis"):
        sharded_batch_eval(cpu_mesh(2))


def _stage_problem(kind):
    """(port evaluator, JAX evaluator, labels, BoostParams) of a 64-sample
    stage; several blocks, some of whose row counts 3 or 8 shards do not
    divide (Haar 5 025 features in blocks of 1 024, LBP 484 in 100, HOG
    1 296 variables in 252)."""
    rng = np.random.default_rng(3)
    labels = (np.arange(64) % 2).astype(np.int32)
    if kind == "HOG":
        samples = rng.integers(90, 110, (64, 32, 32)).astype(np.uint8)
        samples[labels == 1, :, 12:20] = rng.integers(230, 255, (32, 32, 8))
        ev = HOGTrainEvaluator(hog_catalog(32, 32), block_size=252, device="cpu")
        jev = jevaluators.HOGTrainEvaluator(jfeatures.hog_catalog(32, 32), block_size=252)
    elif kind == "LBP GAB":
        samples = rng.integers(0, 256, (64, 12, 12)).astype(np.uint8)
        samples[labels == 1, 3:9, 3:9] //= 4
        ev = LBPTrainEvaluator(lbp_catalog(12, 12), block_size=100, device="cpu")
        jev = jevaluators.LBPTrainEvaluator(jfeatures.lbp_catalog(12, 12), block_size=100)
    else:  # tests/test_parallel.py's Haar problem
        samples = rng.integers(0, 256, (64, 10, 10)).astype(np.uint8)
        samples[labels == 1, 2:7, 2:7] = 230
        ev = HaarTrainEvaluator(haar_catalog(10, 10, "BASIC"), block_size=1024, device="cpu")
        jev = jevaluators.HaarTrainEvaluator(jfeatures.haar_catalog(10, 10, "BASIC"),
                                             block_size=1024)
    params = {"Haar DAB depth 2": boost.BoostParams(boost_type=BOOST_DAB, max_depth=2,
                                                    weak_count=3)}.get(
        kind, boost.BoostParams(weak_count=3))
    ev.set_samples(samples)
    jev.set_samples(samples)
    return ev, jev, labels, params


_STAGES = {}


def _unsharded(kind):
    """(port stage and sums, JAX stage and sums), unsharded, once a kind."""
    if kind not in _STAGES:
        ev, jev, labels, params = _stage_problem(kind)
        jparams = jboost.BoostParams(**{f: getattr(params, f) for f in (
            "boost_type", "min_hit_rate", "max_false_alarm", "weight_trim_rate", "max_depth",
            "weak_count", "min_sample_count")})
        _STAGES[kind] = (boost.StageTrainer(ev, params).train(labels, verbose=False),
                         jboost.StageTrainer(jev, jparams).train(labels, verbose=False))
    return _STAGES[kind]


TREE_FIELDS = ("left", "right", "feature_idx", "threshold", "subsets", "leaf_values")


def _assert_same_stage(a, b):
    assert a is not None and b is not None
    assert a.threshold == b.threshold and len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for f in TREE_FIELDS:
            x, y = getattr(ta, f), getattr(tb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("kind", ["Haar GAB", "Haar DAB depth 2", "LBP GAB", "HOG"])
def test_stage_trainer_sharded_identical(kind, shards):
    """A stage with its features over 3 or 8 shards equals the unsharded
    port stage bit for bit, and the JAX package's unsharded stage (which
    tests/test_parallel.py holds equal to its sharded one): bit for bit
    for Haar and LBP, within 1e-6 for HOG's thresholds (ROADMAP C.4)."""
    ev, _jev, labels, params = _stage_problem(kind)
    (ours, sums), (theirs, jsums) = _unsharded(kind)
    sharded, ssums = boost.StageTrainer(ev, params, mesh=cpu_mesh(shards)).train(
        labels, verbose=False)
    _assert_same_stage(sharded, ours)
    np.testing.assert_array_equal(ssums, sums)
    if kind == "Haar DAB depth 2":
        assert any(t.num_nodes >= 2 for t in ours.trees)
    if kind != "HOG":
        _assert_same_stage(ours, theirs)
        np.testing.assert_array_equal(sums, jsums)
        return
    assert len(ours.trees) == len(theirs.trees)
    np.testing.assert_allclose(ours.threshold, theirs.threshold, rtol=1e-6)
    for ta, tb in zip(ours.trees, theirs.trees):
        for f in ("left", "right", "feature_idx"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f), err_msg=f)
        np.testing.assert_allclose(ta.threshold, tb.threshold, rtol=1e-6)
        np.testing.assert_allclose(ta.leaf_values, tb.leaf_values, rtol=1e-6)


def test_feature_cache_shards():
    """Each local shard holds ⌈B/S⌉ rows of every block on its device, the
    block's rows in order and zero rows past its end; a resident row reads
    back from its shard."""
    ev, _jev, _labels, _params = _stage_problem("Haar GAB")
    full = boost.FeatureCache(ev)
    cache = boost.FeatureCache(ev, mesh=cpu_mesh(8))
    assert cache.shards == list(range(8)) and cache.num_blocks == 5
    for b in range(cache.num_blocks):
        lo, hi = ev.block_slice(b)
        rows = torch.cat([cache.block_values(b, k) for k in range(8)])
        assert rows.shape[0] == 8 * -(-(hi - lo) // 8)
        assert torch.equal(rows[:hi - lo], full.block_values(b))
        assert not rows[hi - lo:].any()
        assert sum(cache.span(b, k)[1] for k in range(8)) == hi - lo
    var = 4100  # block 4 (929 rows): shard 3 holds rows 351..467
    assert cache.span(4, 3) == (4096 + 351, 117)
    assert torch.equal(cache.resident_row(var), full.block_values(4)[var - 4096])
    budget = boost.FeatureCache(ev, val_buf_mb=0.0, mesh=cpu_mesh(8))
    assert budget.n_val == 0 and budget.resident_row(var) is None
    for got, want in zip(budget.shard_inputs(4)[3], cache.sorted_block(4, 3)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shards", [3, 8])
def test_one_class_node_split_over_shards(shards):
    """Under a node of one class, the categorical misclassification
    quality of every split, and of a zero padding row, is the node's
    weight: the search over shards (padding rows masked out) still takes
    the unsharded search's feature and subset."""
    rng = np.random.default_rng(3)
    ev, _jev, labels, _params = _stage_problem("LBP GAB")
    w = rng.uniform(0.1, 1, labels.size)
    node = labels == 0
    splits = []
    for mesh in (None, cpu_mesh(shards)):
        st = boost.StageTrainer(ev, boost.BoostParams(boost_type=BOOST_DAB), mesh=mesh)
        st._cls = labels
        var, subset = st._find_best_split(boost.FeatureCache(ev, mesh=mesh), w,
                                          labels * 2.0 - 1, node)
        splits.append((var, subset.tolist()))
    assert splits[0] == splits[1]
    cache = boost.FeatureCache(ev, mesh=cpu_mesh(shards))
    assert any(cache.span(b, k)[1] < cache.block_values(b, k).shape[0]
               for b in range(cache.num_blocks) for k in range(shards))  # padding exists


def test_meshes_and_their_errors():
    assert cpu_mesh(8).shape == {"feat": 8} and cpu_mesh(8).local_shards == list(range(8))
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)  # no repeat and no CPU unless named
    with pytest.raises(TypeError):
        boost.StageTrainer(_stage_problem("Haar GAB")[0], boost.BoostParams(), mesh=object())


def test_dryrun_multichip():
    """The dry run on 8 CPU shards passes its own checks, and its stage
    takes the JAX package's features on the same problem."""
    out = dryrun_multichip(8, device="cpu")
    assert out["shards"] == 8 and out["devices"] == ["cpu"]
    cat, samples, labels, params = dryrun_problem()
    jev = jevaluators.HaarTrainEvaluator(jfeatures.haar_catalog(10, 10, "BASIC"),
                                         block_size=4096)
    jev.set_samples(samples)
    jstage, _ = jboost.StageTrainer(jev, jboost.BoostParams(weak_count=2, max_depth=1)).train(
        labels, verbose=False)
    assert out["vars"] == [int(t.feature_idx[0]) for t in jstage.trees]
    assert out["trees"] == len(jstage.trees) and len(cat) == 5025


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, extra):
    """Two ranks of parallel/dryrun.py on the CPU joined by gloo → their
    reports, in rank order."""
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"rank{i}.json") for i in range(2)]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cascadeclassifier_tpu_torch.parallel.dryrun", "--rank", str(i),
         "--world", "2", "--coordinator", coord, "--out", outs[i], "--device", "cpu",
         *[a.format(rank=i) for a in extra]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    reports = []
    for i, path in enumerate(outs):
        with open(path) as f:
            reports.append(json.load(f))
        assert reports[-1]["process_id"] == i
    return reports


def test_multihost_split_matches_single_process(tmp_path):
    """Two OS processes, each passing only its half of the feature rows;
    the all_gather crosses the process boundary, and both report the
    one-process JAX answer bit for bit."""
    q, var, thr = jax_best_split(*split_problem())
    for rep in _run_ranks(tmp_path, ["--what", "split"]):
        assert (rep["quality"], rep["var"], rep["threshold"]) == (q, var, float(thr))


def _toy_data(d):
    """12x12 positives (a bright square on dark noise) and one 96x128 noise
    background, as tests/test_parallel.py's CLI test makes them."""
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 90, (120, 12, 12)).astype(np.uint8)
    pos[:, 3:9, 3:9] = rng.integers(190, 256, (120, 6, 6))
    write_vec(str(d / "pos.vec"), pos)
    write_pgm(str(d / "bg.pgm"), rng.integers(0, 256, (96, 128)).astype(np.uint8))
    (d / "bg.txt").write_text(str(d / "bg.pgm") + "\n")
    return str(d / "pos.vec"), str(d / "bg.txt")


def test_multihost_stage_matches_single_process(tmp_path):
    """Two OS processes train stage 0 with CascadeTrainer on a process
    mesh: both return the one-process stage, rank 0 writes the
    one-process stage0.xml bytes, rank 1 writes nothing."""
    vec, bg = _toy_data(tmp_path)
    one = tmp_path / "one"
    CascadeTrainer(win_w=12, win_h=12, device="cpu").train(str(one), vec, bg, num_pos=100,
                                                            num_neg=80, num_stages=1,
                                                            verbose=False)
    want = (one / "stage0.xml").read_text()
    reports = _run_ranks(tmp_path, ["--what", "train", "--vec", vec, "--bg", bg, "-w", "12",
                                    "--num-pos", "100", "--num-neg", "80",
                                    "--data", str(tmp_path / "rank{rank}")])
    assert [r["stage0_xml"] for r in reports] == [want, want]
    assert (tmp_path / "rank0" / "stage0.xml").read_text() == want
    assert sorted(os.listdir(tmp_path / "rank0")) == ["cascade.xml", "params.xml",
                                                      "stage0.xml"]
    assert not (tmp_path / "rank1").exists()


def test_cli_mesh_flag_resolves():
    """-numDevices builds the feature mesh the trainer receives."""
    from cascadeclassifier_tpu_torch.tools.traincascade_cli import (
        build_parser,
        make_trainer,
        resolve_mesh,
    )

    args = build_parser().parse_args(
        ["-data", "/tmp/x", "-vec", "a.vec", "-bg", "bg.txt", "-numDevices", "8", "-w", "12",
         "-h", "12", "-device", "cpu"])
    mesh = resolve_mesh(args)
    assert mesh is not None and mesh.shape == {"feat": 8} and mesh.group is None
    assert mesh.devices == [torch.device("cpu")] * 8
    tr = make_trainer(args, mesh=mesh)
    assert tr.mesh is mesh and tr.device == torch.device("cpu")
    for flags in (["-numDevices", "1"], []):  # one device
        args1 = build_parser().parse_args(
            ["-data", "/tmp/x", "-vec", "a.vec", "-bg", "bg.txt", "-device", "cpu", *flags])
        assert resolve_mesh(args1) is None


def test_cli_sharded_training_identical(tmp_path):
    """CLI-driven sharded training (-numDevices 8 -device cpu) writes the
    stage0.xml of -numDevices 1."""
    from cascadeclassifier_tpu_torch.tools.traincascade_cli import main

    vec, bg = _toy_data(tmp_path)
    outs = {}
    for nd in (1, 8):
        d = tmp_path / f"data{nd}"
        rc = main(["-data", str(d), "-vec", vec, "-bg", bg, "-w", "12", "-h", "12",
                   "-numPos", "100", "-numNeg", "80", "-numStages", "1", "-maxWeakCount", "3",
                   "-numDevices", str(nd), "-device", "cpu"])
        assert rc == 0
        outs[nd] = (d / "stage0.xml").read_bytes()
    assert outs[1] == outs[8]
