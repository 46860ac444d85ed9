"""Cascade visualisation tool (the ``torch-visualisation`` script; a copy
of ``cascadeclassifier_tpu.tools.visualisation_cli``).

Equivalent of the reference opencv_visualisation
(tools/visualisation/opencv_visualisation.cpp): renders the features
selected by each stage of a trained HAAR/LBP stump cascade over a
reference window image, writing one PNG per stage (and a model overview).
--video additionally writes the per-feature animation the reference
streams to model_visualization.avi (opencv_visualisation.cpp:182-192,
235-276): one frame per weak feature, positive-weight rects filled
black, negative filled white, with a "Stage s / Feature f" caption."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def render_stage(model, stage, canvas, scale):
    import cv2

    from cascadeclassifier_tpu_torch.models.model import FEATURE_HAAR, HaarFeature

    vis = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    for tree in stage.trees:
        for ni in range(tree.num_nodes):
            f = model.features[int(tree.feature_idx[ni])]
            if isinstance(f, HaarFeature):
                for (x, y, w, h, wt) in f.rects:
                    color = (0, 0, 255) if wt < 0 else (0, 255, 0)
                    cv2.rectangle(
                        vis,
                        (int(x * scale), int(y * scale)),
                        (int((x + w) * scale), int((y + h) * scale)),
                        color,
                        1,
                    )
            else:  # LBP: draw the 3×3 grid
                x, y, w, h = f.rect
                for gy in range(3):
                    for gx in range(3):
                        cv2.rectangle(
                            vis,
                            (int((x + gx * w) * scale), int((y + gy * h) * scale)),
                            (
                                int((x + (gx + 1) * w) * scale),
                                int((y + (gy + 1) * h) * scale),
                            ),
                            (255, 0, 0),
                            1,
                        )
    return vis


def render_feature_frame(model, canvas, scale, fidx, caption):
    """One video frame: the feature's rects FILLED over the window image
    (weight >= 0 black, < 0 white — opencv_visualisation.cpp:247-271),
    captioned like the reference's putText."""
    import cv2

    from cascadeclassifier_tpu_torch.models.model import HaarFeature

    vis = canvas.copy()
    f = model.features[fidx]
    if isinstance(f, HaarFeature):
        for (x, y, w, h, wt) in f.rects:
            color = 0 if wt >= 0 else 255
            cv2.rectangle(
                vis,
                (int(x * scale), int(y * scale)),
                (int((x + w) * scale), int((y + h) * scale)),
                color,
                -1,
            )
    else:  # LBP: the reference fills the full 3x3 grid extent
        x, y, w, h = f.rect
        cv2.rectangle(
            vis,
            (int(x * scale), int(y * scale)),
            (int((x + 3 * w) * scale), int((y + 3 * h) * scale)),
            0,
            -1,
        )
    cv2.putText(vis, caption, (15, 15), cv2.FONT_HERSHEY_SIMPLEX, 0.5, 255)
    return vis


def write_video(model, canvas, scale, path, fps=15):
    """model_visualization video: one frame per weak feature in stage
    order (reference streams XVID .avi; MJPG/mp4v are tried as fallbacks
    for builds without the XVID encoder)."""
    import cv2

    h, w = canvas.shape[:2]
    writer = None
    for (codec, ext) in (("XVID", ""), ("MJPG", ""), ("mp4v", ".mp4")):
        cand = path + ext if ext and not path.endswith(ext) else path
        vw = cv2.VideoWriter(
            cand, cv2.VideoWriter_fourcc(*codec), fps, (w, h), False
        )
        if vw.isOpened():
            writer, path = vw, cand
            break
        vw.release()
    if writer is None:
        return None, 0
    n = 0
    for si, stage in enumerate(model.stages):
        for ti, tree in enumerate(stage.trees):
            for ni in range(tree.num_nodes):
                frame = render_feature_frame(
                    model, canvas, scale,
                    int(tree.feature_idx[ni]),
                    f"Stage {si} / Feature {ti}",
                )
                writer.write(frame)
                n += 1
    writer.release()
    return path, n


def main(argv=None):
    p = argparse.ArgumentParser(prog="torch-visualisation")
    p.add_argument("--model", required=True, help="cascade.xml")
    p.add_argument("--image", default=None,
                   help="reference window image (defaults to gray canvas)")
    p.add_argument("--data", default="model_visualisation",
                   help="output directory")
    p.add_argument("--scale", type=int, default=10)
    p.add_argument("--video", action="store_true",
                   help="also write the per-feature animation "
                        "(model_visualization.avi, reference "
                        "opencv_visualisation.cpp:182-192)")
    args = p.parse_args(argv)

    import cv2

    from cascadeclassifier_tpu_torch.models.model import FEATURE_HOG
    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml

    model = read_cascade_xml(args.model)
    if model.feature_type == FEATURE_HOG:
        print("visualisation supports HAAR/LBP models", file=sys.stderr)
        return 1
    os.makedirs(args.data, exist_ok=True)
    if args.image:
        canvas = cv2.imread(args.image, cv2.IMREAD_GRAYSCALE)
        canvas = cv2.resize(
            canvas, (model.width * args.scale, model.height * args.scale),
            interpolation=cv2.INTER_NEAREST,
        )
    else:
        canvas = np.full(
            (model.height * args.scale, model.width * args.scale), 160, np.uint8
        )
    for si, stage in enumerate(model.stages):
        vis = render_stage(model, stage, canvas, args.scale)
        cv2.imwrite(os.path.join(args.data, f"stage_{si:03d}.png"), vis)
    print(f"Wrote {model.num_stages} stage visualisations to {args.data}/")
    if args.video:
        path, n = write_video(
            model, canvas, args.scale,
            os.path.join(args.data, "model_visualization.avi"),
        )
        if path is None:
            print("no usable video encoder (XVID/MJPG/mp4v)",
                  file=sys.stderr)
            return 1
        print(f"Wrote {n}-frame feature animation to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
