"""The sharded trainer across several cards, checked and timed.

    python3 -m cascadeclassifier_tpu_torch.utils.mesh_check [--cards 4]

on a machine with that many cards (``--device cpu`` rehearses the same
steps with its shards on the CPU and gloo in place of NCCL, at a size
given by ``--n-pos``, ``--n-neg``, ``--bg``). On chip_smoke's training
data (``utils/train_data.py``: 1 000 + 2 000 samples of 24×24, Haar
BASIC's 162 336 features):

1. the split search over the cards (``make_mesh(N)``: shard k on cuda:k)
   equals ``split_scan_gather`` + ``best_of_block`` over stage 0's first
   block on cuda:0, bit for bit; both timed;
2. stage 0 (Haar GAB, LBP GAB, Haar DAB at depth 2) with
   ``CascadeTrainer(mesh=make_mesh(N))`` writes the one-card stage0.xml
   byte for byte; s/stage and ``train_stage`` both ways, in the order one
   card, N cards, N cards, one card;
3. N processes, one a card, joined by NCCL (``parallel/dryrun.py``): the
   Haar stage 0 (rank 0 writes the one-card bytes, the others nothing,
   every rank returns the same stage) and the split problem of the JAX
   package's tests (every rank reports the one-process answer);
4. ``dryrun_multichip(N)``.

Exits non-zero on any difference; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _check(cond, msg: str):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(dev):
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _ms(fn, dev, reps: int = 10) -> float:
    """Wall ms a call, the devices synchronized around the calls."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _ranks(n: int, args, extra: list, work: str) -> list:
    """n ranks of parallel/dryrun.py → their reports in rank order."""
    coord = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(work, f"rank{i}.json") for i in range(n)]
    device = ["--device", "cpu"] if args.device == "cpu" else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cascadeclassifier_tpu_torch.parallel.dryrun", "--rank", str(i),
         "--world", str(n), "--coordinator", coord, "--out", outs[i], *device,
         *[a.format(rank=i) for a in extra]],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    _check(all(p.returncode == 0 for p in procs), "a rank failed:\n" + "\n".join(logs))
    reports = []
    for path in outs:
        with open(path) as f:
            reports.append(json.load(f))
    return reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cascadeclassifier_tpu_torch.utils.mesh_check")
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--n-pos", type=int, default=1000)
    p.add_argument("--n-neg", type=int, default=2000)
    p.add_argument("--bg", type=int, nargs=3, default=[20, 1080, 1920],
                   metavar=("COUNT", "HEIGHT", "WIDTH"), help="clutter backgrounds")
    args = p.parse_args(argv)

    from cascadeclassifier_tpu_torch.data.negreader import NegReader
    from cascadeclassifier_tpu_torch.data.vec import PosReader, write_vec
    from cascadeclassifier_tpu_torch.models.model import BOOST_DAB, FEATURE_LBP
    from cascadeclassifier_tpu_torch.ops.features import haar_catalog
    from cascadeclassifier_tpu_torch.parallel.dryrun import dryrun_multichip, split_problem
    from cascadeclassifier_tpu_torch.parallel.sharded import (
        make_mesh,
        shard_features,
        sharded_ordered_best_split,
    )
    from cascadeclassifier_tpu_torch.train.boost import BoostParams, best_of_block
    from cascadeclassifier_tpu_torch.train.evaluators import HaarTrainEvaluator
    from cascadeclassifier_tpu_torch.train.split import split_scan_gather, tree_sum
    from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer
    from cascadeclassifier_tpu_torch.utils import train_data
    from cascadeclassifier_tpu_torch.utils.profiling import reset_timings, timings

    n = args.cards
    if args.device == "cuda":
        _check(torch.cuda.device_count() >= n,
               f"{n} cards asked, {torch.cuda.device_count()} present")
        mesh, home = make_mesh(n), torch.device("cuda:0")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
        where = f"{n} cards ({'; '.join(card)})"
    else:
        mesh, home = make_mesh(n, devices=["cpu"] * n), torch.device("cpu")
        where = f"{n} CPU shards (a rehearsal: no device time)"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        vec = os.path.join(work, "pos.vec")
        write_vec(vec, train_data.positives(args.n_pos + args.n_pos // 5, 24, seed=7))
        names = []
        for k in range(args.bg[0]):
            names.append(os.path.join(work, f"bg{k}.pgm"))
            train_data.write_pgm(names[-1], train_data.background(*args.bg[1:], seed=100 + k))
        bg = os.path.join(work, "bg.txt")
        with open(bg, "w") as f:
            f.write("\n".join(names) + "\n")
        print(f"mesh_check on {where}: data {time.perf_counter() - t0:.1f} s", flush=True)

        # 1. the split search over the cards against one card's
        tr = CascadeTrainer(device=home)
        pos = tr._fill_positives(PosReader(vec, 24, 24), args.n_pos, [0])
        neg = tr._fill_negatives(NegReader(bg, 24, 24, lazy=True), args.n_neg, 0.0, [0])
        n_real = args.n_pos + args.n_neg
        n_pad = -(-n_real // 256) * 256
        ev = HaarTrainEvaluator(haar_catalog(24, 24, "BASIC"), device=home)
        ev.set_samples(np.concatenate([pos, neg, np.zeros((n_pad - n_real, 24, 24), np.uint8)]))
        valid = np.arange(n_pad) < n_real
        resp = np.where(np.arange(n_pad) < args.n_pos, 1.0, -1.0)
        w = np.where(valid, np.random.default_rng(11).uniform(0.2, 1.0, n_pad), 0.0)
        wm = np.where(valid, w, 0.0)
        tw, tr_sum = tree_sum(wm), tree_sum(wm * resp)
        values = ev.values_block(0)
        vs_bn, si_bn = torch.sort(values, dim=1, stable=True)
        tables = [torch.as_tensor(a, device=home) for a in (wm, wm * resp, valid)]

        def one_card():
            q, thr = split_scan_gather(vs_bn.t(), si_bn.t(), *tables, tw, tr_sum)
            qm, i = best_of_block(q)
            return float(qm), int(i), np.float32(thr[i].item())

        want = one_card()
        shards = shard_features(mesh, values, si_bn)
        fn = sharded_ordered_best_split(mesh)
        got = fn(*shards, w, resp, valid)
        _check(got == want, f"check 1: the split over {n} shards {got} != one card's {want}")
        print(f"check 1: the split over {n} shards of stage 0's block ({values.shape[0]} "
              f"features x {n_pad} samples) equals one card's bit for bit (feature {want[1]}); "
              f"ms: sharded {_ms(lambda: fn(*shards, w, resp, valid), home):.4f} (each shard "
              f"gathers its sorted values), one card {_ms(one_card, home):.4f}", flush=True)

        # 2. stage 0 over the cards in this process against one card
        unsharded = {}
        runs = (("haar", {}), ("lbp", dict(feature_type=FEATURE_LBP)),
                ("dab_d2", dict(boost=BoostParams(boost_type=BOOST_DAB, max_depth=2))))
        for tag, kw in runs:
            xml, times = None, {"one": [], "mesh": []}
            for k, (name, m) in enumerate((("one", None), ("mesh", mesh), ("mesh", mesh),
                                           ("one", None))):
                d = os.path.join(work, f"{tag}_{k}")
                reset_timings()
                _sync(home)
                CascadeTrainer(device=home, mesh=m, **kw).train(
                    d, vec, bg, num_pos=args.n_pos, num_neg=args.n_neg, num_stages=1,
                    verbose=False)
                _sync(home)
                tm = {key: v[0] for key, v in timings().items()}
                times[name].append(f"{sum(tm.values()):.3f} (train_stage "
                                   f"{tm['train_stage']:.3f})")
                with open(os.path.join(d, "stage0.xml"), "rb") as f:
                    got = f.read()
                xml = got if xml is None else xml
                _check(got == xml, f"check 2 ({tag}): run {k} ({name}) wrote other bytes")
            unsharded[tag] = xml
            print(f"check 2 ({tag}): stage 0 at {args.n_pos} + {args.n_neg} over {n} shards: "
                  f"stage0.xml byte-identical to one card's ({xml.count(b'<internalNodes>')} "
                  f"trees); s/stage one card {' / '.join(times['one'])}, {n} shards "
                  f"{' / '.join(times['mesh'])}", flush=True)

        # 3. n processes, one a card
        t3 = time.perf_counter()
        reports = _ranks(n, args, ["--what", "train", "--vec", vec, "--bg", bg, "--num-pos",
                                   str(args.n_pos), "--num-neg", str(args.n_neg), "--data",
                                   os.path.join(work, "rank{rank}")], work)
        with open(os.path.join(work, "rank0", "stage0.xml"), "rb") as f:
            written = f.read()
        _check(written == unsharded["haar"], "check 3: rank 0's stage0.xml != one card's")
        _check(all(r["stage0_xml"].encode() == written for r in reports),
               "check 3: a rank returned another stage")
        _check(not any(os.path.exists(os.path.join(work, f"rank{i}")) for i in range(1, n)),
               "check 3: a rank other than 0 wrote")
        q, var, thr = sharded_ordered_best_split(make_mesh(1, devices=[home]))(
            *(torch.as_tensor(a, device=home) for a in split_problem()[:2]),
            *split_problem()[2:])
        reports = _ranks(n, args, ["--what", "split"], work)
        _check(all((r["quality"], r["var"], r["threshold"]) == (q, var, float(thr))
                   for r in reports), f"check 3: the ranks' split {reports} != ({q}, {var}, "
                                      f"{thr})")
        print(f"check 3: {n} processes joined by {'gloo' if args.device == 'cpu' else 'NCCL'}: "
              f"stage 0 (rank 0 writes one card's bytes, the others nothing, every rank "
              f"returns it) and the split problem (every rank the one-process answer); "
              f"{time.perf_counter() - t3:.1f} s", flush=True)

    # 4. the dry run
    out = dryrun_multichip(n, device=args.device)
    _check(len(out["devices"]) == (n if args.device == "cuda" else 1), f"check 4: {out}")
    print(f"mesh_check OK on {where}; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
