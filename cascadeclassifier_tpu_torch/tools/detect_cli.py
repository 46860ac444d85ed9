"""Detection CLI (the ``torch-detect`` script).

Counterpart of ``cascadeclassifier_tpu/tools/detect_cli.py``, with its
flags and output lines (one ``x y w h`` a detection; defaults of the
reference sample: scaleFactor=4, minNeighbors=50, main.cpp:45). The
detector is ``detect/detector.py::make_detector`` on ``--device`` (cuda
by default; cpu only when asked): ``TorchDetector`` for Haar and LBP
cascades, ``HOGDetector`` for a HOG cascade (no engine flag applies).
``--engine`` takes the port's engines; the JAX package's "xla" and
"compact" are not ported. PGM and 8-bit grayscale PNG images are read
without cv2 (``data/negreader.py::imread_gray``); other formats and
``-o`` need cv2.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="torch-detect")
    p.add_argument("cascade", help="cascade.xml")
    p.add_argument("image", help="input image")
    p.add_argument("--scale-factor", type=float, default=4.0)
    p.add_argument("--min-neighbors", type=int, default=50)
    p.add_argument("--min-size", type=int, nargs=2, default=None)
    p.add_argument("--max-size", type=int, nargs=2, default=None)
    p.add_argument("-o", "--output", default=None,
                   help="write annotated image here")
    p.add_argument("--fast", action="store_true",
                   help="float32 stage sums (near-exact)")
    p.add_argument("--engine", choices=["auto", "fused", "pallas"],
                   default="auto", help="stage-evaluation engine")
    p.add_argument("--device", default="cuda", help="cuda (the default), cuda:k or cpu")
    args = p.parse_args(argv)

    from cascadeclassifier_tpu_torch.data.negreader import imread_gray
    from cascadeclassifier_tpu_torch.detect.detector import make_detector
    from cascadeclassifier_tpu_torch.models.model import FEATURE_HOG
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml

    img = imread_gray(args.image)
    if img is None:
        print(f"cannot read {args.image}", file=sys.stderr)
        return 1
    model = read_cascade_xml(args.cascade)
    if model.feature_type == FEATURE_HOG:
        # OpenCV's runtime serves no HOG cascade (SURVEY §2.3): the
        # crop-consistent HOG detector does, and no engine flag applies
        print(
            "note: HOG cascades run the crop-consistent detector (the "
            "training predictor over every window; far slower than the "
            "Haar/LBP engines)",
            file=sys.stderr,
        )
        det = make_detector(model, device=args.device)
    else:
        det = make_detector(model, device=args.device, exact=not args.fast,
                            engine=args.engine)
    rects = det.detect_multi_scale(
        img,
        scale_factor=args.scale_factor,
        min_neighbors=args.min_neighbors,
        min_size=args.min_size,
        max_size=args.max_size,
    )
    for (x, y, w, h) in rects:
        print(f"{x} {y} {w} {h}")
    if args.output:
        import cv2

        vis = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        for (x, y, w, h) in rects:
            cv2.rectangle(vis, (int(x), int(y)), (int(x + w), int(y + h)),
                          (0, 0, 255), 2)
        cv2.imwrite(args.output, vis)
    return 0


if __name__ == "__main__":
    sys.exit(main())
