"""createsamples-compatible CLI (reference: createsamples.cpp:36-218).

A copy of ``cascadeclassifier_tpu.tools.createsamples_cli``; the
``torch-createsamples`` script."""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="torch-createsamples",
        description="Training-sample synthesis (opencv_createsamples"
        "-compatible)",
        add_help=False,  # -h means sample height, like the reference CLI
    )
    p.add_argument("--help", action="help")
    p.add_argument("-vec", default=None)
    p.add_argument("-img", default=None)
    p.add_argument("-info", default=None)
    p.add_argument("-bg", default=None)
    p.add_argument("-num", type=int, default=1000)
    p.add_argument("-bgcolor", type=int, default=0)
    p.add_argument("-bgthresh", type=int, default=80)
    p.add_argument("-inv", action="store_true")
    p.add_argument("-randinv", action="store_true")
    p.add_argument("-maxidev", type=int, default=40)
    p.add_argument("-maxxangle", type=float, default=1.1)
    p.add_argument("-maxyangle", type=float, default=1.1)
    p.add_argument("-maxzangle", type=float, default=0.5)
    p.add_argument("-show", default=None, nargs="?", const="samples_out")
    p.add_argument("-w", type=int, default=24, dest="win_w")
    p.add_argument("-h", type=int, default=24, dest="win_h")
    p.add_argument("-rngseed", type=int, default=12345)
    return p


def main(argv=None):
    from cascadeclassifier_tpu_torch.tools import createsamples as cs

    args = build_parser().parse_args(argv)
    # mode dispatch mirrors createsamples.cpp:184-218
    if args.img and args.bg and args.info:
        n = cs.create_test_samples(
            args.info, args.img, args.bg, args.num,
            bgcolor=args.bgcolor, bgthreshold=args.bgthresh,
            invert=args.inv, maxintensitydev=args.maxidev,
            maxxangle=args.maxxangle, maxyangle=args.maxyangle,
            maxzangle=args.maxzangle, win_w=args.win_w, win_h=args.win_h,
            rngseed=args.rngseed,
        )
        print(f"Done. Created {n} test samples")
    elif args.img and args.vec:
        n = cs.create_training_samples(
            args.vec,
            args.img,
            args.num,
            bgcolor=args.bgcolor,
            bgthreshold=args.bgthresh,
            bg_path=args.bg,
            invert=args.inv,
            maxintensitydev=args.maxidev,
            maxxangle=args.maxxangle,
            maxyangle=args.maxyangle,
            maxzangle=args.maxzangle,
            win_w=args.win_w,
            win_h=args.win_h,
            rngseed=args.rngseed,
        )
        print(f"Done. Created {n} samples")
    elif args.info and args.vec:
        n = cs.create_samples_from_info(
            args.info, args.vec, args.num, args.win_w, args.win_h
        )
        print(f"Done. Created {n} samples")
    elif args.vec and args.show is not None:
        n = cs.show_vec_samples(
            args.vec, args.show,
            width=args.win_w or None, height=args.win_h or None,
        )
        print(f"Dumped up to 64 of {n} samples to {args.show}/")
    else:
        build_parser().print_help()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
