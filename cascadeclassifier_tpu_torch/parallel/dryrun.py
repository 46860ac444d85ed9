"""Multi-device dry run, and a worker for meshes of processes.

``dryrun_multichip(n)`` is the counterpart of ``__graft_entry__.py::
dryrun_multichip``: one stage of the real trainer (10×10 Haar BASIC, 64
samples, two weak trees) with its features sharded over n shards must
equal the one-device stage bit for bit, and ``sharded_batch_eval`` over n
sample shards must match ``corner_m @ rows.T @ w``. Where the JAX function
re-executes itself on a virtual CPU mesh, this one puts its n shards on
the card (repeating cards when there are fewer than n), and on the CPU
only when asked (``device="cpu"``).

As a program it is one rank of a process mesh (the JAX package's
``tests/multihost_worker.py``)::

    python -m cascadeclassifier_tpu_torch.parallel.dryrun --rank I --world N \\
        --coordinator HOST:PORT --out REPORT.json [--device cpu] [--backend gloo] \\
        [--what split | train --vec POS.vec --bg BG.txt --data DIR [-w 24] \\
         [--num-pos 1000] [--num-neg 2000]]

``split`` runs the JAX test's seed-0 64×96 split search, this rank
passing only its own feature rows; ``train`` trains stage 0 with
``CascadeTrainer(mesh=)`` into DIR (rank 0 alone writes there). The
report holds the rank's answer: the split, or the trained stage's XML.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from cascadeclassifier_tpu_torch.parallel.sharded import (
    init_distributed,
    make_mesh,
    process_mesh,
    shard_features,
    shard_span,
    sharded_batch_eval,
    sharded_ordered_best_split,
)


def shard_devices(n: int, device="cuda") -> list:
    """n shard devices: the CPU n times, a named card n times, or "cuda"
    as cuda:i modulo the cards present (none raises)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu'")
    return [torch.device(f"cuda:{i % count}") for i in range(n)]


def dryrun_problem():
    """The JAX dry run's stage problem: (catalog, samples, labels, params)."""
    from cascadeclassifier_tpu_torch.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu_torch.train.boost import BoostParams

    rng = np.random.default_rng(0)
    win, n = 10, 64
    samples = rng.integers(0, 256, (n, win, win)).astype(np.uint8)
    labels = (np.arange(n) % 2).astype(np.int32)
    samples[labels == 1, 2:7, 2:7] = 230  # a separable bright blob
    return haar_catalog(win, win, HAAR_BASIC), samples, labels, BoostParams(weak_count=2,
                                                                            max_depth=1)


def split_problem():
    """The JAX tests' seed-0 split search: (values (64, 96) f32, stable sort
    order, w, resp, mask)."""
    rng = np.random.default_rng(0)
    f, n = 64, 96
    values = rng.normal(size=(f, n)).astype(np.float32)
    sort_idx = np.argsort(values, axis=1, kind="stable")
    w = rng.uniform(0.1, 1, n)
    w /= w.sum()
    resp = rng.choice([-1.0, 1.0], n)
    return values, sort_idx, w, resp, np.ones(n, bool)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded stage and one sample-sharded product on n shards,
    checked against one device; raises on a difference → a summary."""
    from cascadeclassifier_tpu_torch.train.boost import StageTrainer
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator

    devs = shard_devices(n_devices, device)
    cat, samples, labels, params = dryrun_problem()
    stages = []
    for mesh in (make_mesh(n_devices, devices=devs), None):
        ev = HaarTrainEvaluator(cat, block_size=4096, device=devs[0])
        ev.set_samples(samples)
        stages.append(StageTrainer(ev, params, mesh=mesh).train(labels, verbose=False))
    (sharded, sums_sharded), (local, sums_local) = stages
    if sharded is None or local is None or len(sharded.trees) != len(local.trees):
        raise AssertionError(f"dryrun: sharded stage {sharded} against one device's {local}")
    if sharded.threshold != local.threshold:
        raise AssertionError(f"dryrun: stage thresholds {sharded.threshold} != {local.threshold}")
    for ts, tl in zip(sharded.trees, local.trees):
        for f in ("feature_idx", "threshold", "leaf_values", "left", "right"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(tl, f), err_msg=f)
    np.testing.assert_array_equal(sums_sharded, sums_local)

    rng = np.random.default_rng(0)
    p_len, b = 128, 8 * n_devices
    corner_m = rng.normal(size=(32, p_len)).astype(np.float32)
    sum_rows = rng.normal(size=(b, p_len)).astype(np.float32)
    wts = np.full(b, 1.0 / b, np.float32)
    mesh_d = make_mesh(n_devices, axis="data", devices=devs)
    rows, _ = shard_features(mesh_d, sum_rows)
    w_sh, _ = shard_features(mesh_d, wts)
    _vals, wsum = sharded_batch_eval(mesh_d)(corner_m, rows, w_sh)
    ref = corner_m.astype(np.float64) @ sum_rows.T.astype(np.float64) @ wts.astype(np.float64)
    np.testing.assert_allclose(wsum.cpu().numpy(), ref, rtol=1e-4)
    out = {"shards": n_devices, "devices": sorted({str(d) for d in devs}),
           "trees": len(sharded.trees),
           "vars": [int(t.feature_idx[0]) for t in sharded.trees],
           "wsum_max_abs_err": float(np.abs(wsum.cpu().numpy() - ref).max())}
    print(f"dryrun_multichip OK on {n_devices} shards ({', '.join(out['devices'])}): sharded "
          f"StageTrainer stage identical to one device's ({out['trees']} trees, vars "
          f"{out['vars']}); sample-sharded product max err {out['wsum_max_abs_err']:.2e}")
    return out


def _split_report(mesh) -> dict:
    values, sort_idx, w, resp, mask = split_problem()
    lo, n, _per = shard_span(values.shape[0], mesh.size, mesh.rank)
    dev = mesh.devices[0]
    fn = sharded_ordered_best_split(mesh)
    q, var, thr = fn(torch.as_tensor(values[lo:lo + n], device=dev),
                     torch.as_tensor(sort_idx[lo:lo + n], device=dev), w, resp, mask)
    return {"quality": q, "var": var, "threshold": float(thr)}


def _train_report(mesh, args) -> dict:
    from cascadeclassifier_tpu_torch.models.xml_io import write_stage_xml
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer

    trainer = CascadeTrainer(win_w=args.w, win_h=args.w, mesh=mesh, device=mesh.devices[0])
    model = trainer.train(args.data, args.vec, args.bg, num_pos=args.num_pos,
                          num_neg=args.num_neg, num_stages=1, verbose=False)
    if model is None:
        raise RuntimeError("no stage trained")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stage0.xml")
        write_stage_xml(trainer.stages[0], False, path, node_name="stage0")
        with open(path) as f:
            return {"stage0_xml": f.read()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cascadeclassifier_tpu_torch.parallel.dryrun")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--coordinator", required=True, help="host:port of rank 0")
    p.add_argument("--out", required=True, help="the rank's report (JSON)")
    p.add_argument("--device", default=None, help="default: cuda:{rank %% cards}")
    p.add_argument("--backend", default=None, help="default: nccl on a card, gloo on the CPU")
    p.add_argument("--what", choices=["split", "train"], default="split")
    p.add_argument("--vec")
    p.add_argument("--bg")
    p.add_argument("--data")
    p.add_argument("-w", type=int, default=24)
    p.add_argument("--num-pos", type=int, default=1000)
    p.add_argument("--num-neg", type=int, default=2000)
    args = p.parse_args(argv)
    mesh = init_distributed(args.coordinator, args.world, args.rank, backend=args.backend,
                            device=args.device)
    with process_mesh(mesh):
        report = _split_report(mesh) if args.what == "split" else _train_report(mesh, args)
    with open(args.out, "w") as f:
        json.dump({"process_id": args.rank, **report}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
