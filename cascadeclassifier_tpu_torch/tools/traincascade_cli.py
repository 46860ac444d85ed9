"""traincascade-compatible CLI (the ``torch-traincascade`` script).

Counterpart of ``cascadeclassifier_tpu/tools/traincascade_cli.py``, with
its flags and transcript: the reference binary's flag surface
(traincascade.cpp:39-166; defaults numPos=2000, numNeg=1000, numStages=20,
winSize 24×24, HAAR BASIC, GAB stumps), the precalc budgets as
FeatureCache block residency (train/boost.py), and the feature-sharded
training mesh (-numDevices, -dist*). Two flags are the port's own:
``-device`` (cuda by default; cpu only when asked) and ``-distBackend``.

Across processes, each process runs this command with its -distProcessId;
rank i trains on cuda:{i % cards} (or the CPU with -device cpu), and rank
0 alone writes the checkpoints and the cascade into -data.
"""

from __future__ import annotations

import argparse
import sys

import torch

from cascadeclassifier_tpu_torch.models.model import BOOST_TYPE_IDS, FEATURE_TYPE_IDS
from cascadeclassifier_tpu_torch.parallel.sharded import init_distributed, make_mesh, process_mesh
from cascadeclassifier_tpu_torch.train.boost import BoostParams
from cascadeclassifier_tpu_torch.train.trainer import CascadeTrainer


def build_parser():
    p = argparse.ArgumentParser(
        prog="torch-traincascade",
        description="PyTorch/CUDA cascade classifier trainer "
        "(opencv_traincascade-compatible)",
        add_help=False,  # -h means sample height, like the reference CLI
    )
    p.add_argument("--help", action="help")
    p.add_argument("-data", required=True, help="output directory")
    p.add_argument("-vec", required=True, help=".vec file with positives")
    p.add_argument("-bg", required=True, help="background image list")
    p.add_argument("-numPos", type=int, default=2000)
    p.add_argument("-numNeg", type=int, default=1000)
    p.add_argument("-numStages", type=int, default=20)
    p.add_argument("-precalcValBufSize", type=int, default=1024,
                   help="resident feature-value budget, MB")
    p.add_argument("-precalcIdxBufSize", type=int, default=1024,
                   help="resident sort-order budget, MB")
    p.add_argument("-baseFormatSave", action="store_true")
    p.add_argument("-numThreads", type=int, default=None,
                   help="accepted for compatibility")
    p.add_argument("-acceptanceRatioBreakValue", type=float, default=-1.0)
    # cascade params
    p.add_argument("-stageType", default="BOOST", choices=["BOOST"])
    p.add_argument("-featureType", default="HAAR",
                   choices=["HAAR", "LBP", "HOG"])
    p.add_argument("-w", type=int, default=24, dest="win_w")
    p.add_argument("-h", type=int, default=24, dest="win_h")
    # boost params
    p.add_argument("-bt", default="GAB", choices=["DAB", "RAB", "LB", "GAB"])
    p.add_argument("-minHitRate", type=float, default=0.995)
    p.add_argument("-maxFalseAlarmRate", type=float, default=0.5)
    p.add_argument("-weightTrimRate", type=float, default=0.95)
    p.add_argument("-maxDepth", type=int, default=1)
    p.add_argument("-maxWeakCount", type=int, default=100)
    # haar params
    p.add_argument("-mode", default="BASIC", choices=["BASIC", "CORE", "ALL"])
    # where to train, and the feature-sharded mesh of the split search
    p.add_argument("-device", default="cuda",
                   help="cuda (the default: every card), cuda:k (one card) or cpu")
    p.add_argument("-numDevices", type=int, default=None,
                   help="shards of the feature-sharded training mesh (0/1 = one "
                   "device; default: every card when -device cuda sees more than "
                   "one); with -device cpu or cuda:k, that device holds every shard")
    p.add_argument("-distCoordinator", default=None,
                   help="host:port of process 0 for training across processes "
                   "(torch.distributed)")
    p.add_argument("-distNumProcesses", type=int, default=None)
    p.add_argument("-distProcessId", type=int, default=None)
    p.add_argument("-distBackend", default=None,
                   help="torch.distributed backend (default: nccl on cards, gloo on the CPU)")
    return p


def rank_device(args) -> torch.device:
    """The device this process trains on: -device, and with -dist* and
    -device cuda rank i's card, cuda:{i % cards}."""
    dev = torch.device(args.device)
    if args.distCoordinator is not None and dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("-device cuda: no CUDA device; pass -device cpu")
        dev = torch.device(f"cuda:{args.distProcessId % count}")
    return dev


def resolve_mesh(args):
    """The training mesh the flags describe, or None (one device).

    With -distCoordinator, this process joins the process group and holds
    one shard of a process mesh. Otherwise -numDevices shards in this
    process: over the first cards (-device cuda), or all on the named
    device (-device cpu, -device cuda:k)."""
    dev = rank_device(args)
    if args.distCoordinator is not None:
        return init_distributed(args.distCoordinator, args.distNumProcesses,
                                args.distProcessId, backend=args.distBackend, device=dev)
    n = args.numDevices
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if n <= 1:
        return None
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(n)
    return make_mesh(n, devices=[dev] * n)


def make_trainer(args, mesh=None):
    boost = BoostParams(
        boost_type=BOOST_TYPE_IDS[args.bt],
        min_hit_rate=args.minHitRate,
        max_false_alarm=args.maxFalseAlarmRate,
        weight_trim_rate=args.weightTrimRate,
        max_depth=args.maxDepth,
        weak_count=args.maxWeakCount,
    )
    return CascadeTrainer(
        feature_type=FEATURE_TYPE_IDS[args.featureType],
        win_w=args.win_w,
        win_h=args.win_h,
        haar_mode=args.mode,
        boost=boost,
        precalc_val_mb=args.precalcValBufSize,
        precalc_idx_mb=args.precalcIdxBufSize,
        mesh=mesh,
        device=rank_device(args),
    )


def print_parameters(args, trainer):
    """Reference-style parameter echo (traincascade.cpp prints the same
    block before training; the feature-count line matches res/README.md
    transcripts)."""
    print("PARAMETERS:")
    print(f"cascadeDirName: {args.data}")
    print(f"vecFileName: {args.vec}")
    print(f"bgFileName: {args.bg}")
    print(f"numPos: {args.numPos}")
    print(f"numNeg: {args.numNeg}")
    print(f"numStages: {args.numStages}")
    print(f"precalcValBufSize[Mb] : {args.precalcValBufSize}")
    print(f"precalcIdxBufSize[Mb] : {args.precalcIdxBufSize}")
    print(f"acceptanceRatioBreakValue : {args.acceptanceRatioBreakValue:g}")
    print(f"stageType: {args.stageType}")
    print(f"featureType: {args.featureType}")
    print(f"sampleWidth: {args.win_w}")
    print(f"sampleHeight: {args.win_h}")
    print(f"boostType: {args.bt}")
    print(f"minHitRate: {args.minHitRate}")
    print(f"maxFalseAlarmRate: {args.maxFalseAlarmRate}")
    print(f"weightTrimRate: {args.weightTrimRate}")
    print(f"maxDepth: {args.maxDepth}")
    print(f"maxWeakCount: {args.maxWeakCount}")
    print(
        "Number of unique features given windowSize "
        f"[{args.win_w},{args.win_h}] : {trainer.evaluator.var_count}"
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = resolve_mesh(args)
    with process_mesh(mesh):
        trainer = make_trainer(args, mesh=mesh)
        print_parameters(args, trainer)
        if mesh is not None:
            print(f"trainingMesh: {mesh.shape}")
        model = trainer.train(
            args.data,
            args.vec,
            args.bg,
            num_pos=args.numPos,
            num_neg=args.numNeg,
            num_stages=args.numStages,
            acceptance_ratio_break=args.acceptanceRatioBreakValue,
            base_format_save=args.baseFormatSave,
        )
    return 0 if model is not None else 1


if __name__ == "__main__":
    sys.exit(main())
