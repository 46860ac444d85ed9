"""Annotation utilities (reference: tools/annotation/opencv_annotation.cpp).

A copy of ``cascadeclassifier_tpu.tools.annotation``.

The reference tool is an interactive bbox labeller writing lines of
``file N x y w h …``. Headless environments can't run the GUI, so this
module provides:

  - parse/write round-trip of the annotation format (shared with
    createsamples -info mode)
  - normalization of rects drawn in any drag direction
    (opencv_annotation.cpp:142-174)
  - an optional interactive annotator using cv2.imshow when a display is
    available (same keybindings: c=confirm, d=delete last, n=next, ESC)
"""

from __future__ import annotations

import os


def normalize_rect(x1, y1, x2, y2):
    """Any drag direction → (x, y, w, h) (opencv_annotation.cpp:142-174)."""
    x, xe = sorted((x1, x2))
    y, ye = sorted((y1, y2))
    return (x, y, xe - x, ye - y)


def read_annotations(path):
    """Parse 'file N x y w h ...' lines → {filename: [(x,y,w,h), ...]}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            fname, n = parts[0], int(parts[1])
            vals = [int(v) for v in parts[2:]]
            out[fname] = [
                tuple(vals[4 * i : 4 * i + 4]) for i in range(n)
            ]
    return out


def write_annotations(path, annotations: dict):
    with open(path, "w") as f:
        for fname, rects in annotations.items():
            flat = " ".join(
                f"{x} {y} {w} {h}" for (x, y, w, h) in rects
            )
            f.write(f"{fname} {len(rects)}{' ' + flat if flat else ''}\n")


def annotate_interactive(images_dir, annotations_path, resize_factor=1):
    """Interactive annotator (requires a display)."""
    import cv2

    files = sorted(
        os.path.join(images_dir, f)
        for f in os.listdir(images_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    ann = {}
    state = {"pt1": None, "pt2": None, "drawing": False, "rects": []}

    def on_mouse(event, x, y, flags, param):
        if event == cv2.EVENT_LBUTTONDOWN:
            state["pt1"] = (x, y)
            state["drawing"] = True
        elif event == cv2.EVENT_LBUTTONUP and state["drawing"]:
            state["pt2"] = (x, y)
            state["drawing"] = False

    cv2.namedWindow("annotate")
    cv2.setMouseCallback("annotate", on_mouse)
    for path in files:
        img = cv2.imread(path)
        if resize_factor > 1:
            img = cv2.resize(
                img,
                (img.shape[1] // resize_factor, img.shape[0] // resize_factor),
            )
        state["rects"] = []
        while True:
            vis = img.copy()
            for (x, y, w, h) in state["rects"]:
                cv2.rectangle(vis, (x, y), (x + w, y + h), (0, 255, 0), 2)
            cv2.imshow("annotate", vis)
            k = cv2.waitKey(30) & 0xFF
            if state["pt1"] and state["pt2"]:
                r = normalize_rect(*state["pt1"], *state["pt2"])
                state["rects"].append(r)
                state["pt1"] = state["pt2"] = None
            if k == ord("d") and state["rects"]:
                state["rects"].pop()
            elif k == ord("n"):
                break
            elif k == 27:
                files = []
                break
        scale = resize_factor
        ann[path] = [
            (x * scale, y * scale, w * scale, h * scale)
            for (x, y, w, h) in state["rects"]
        ]
        if not files:
            break
    write_annotations(annotations_path, ann)
    return ann
