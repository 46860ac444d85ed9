"""Write an OpenCV golden for chip_smoke.py: synth frames through the
OpenCV C++ runtime (``oracle/detect_oracle``).

    python -m cascadeclassifier_tpu_torch.utils.golden \\
        haarcascade_upperbody.xml smoke_golden_upperbody_1080p.json

reads the cascade from ``cascadeclassifier_tpu_torch/data/``, writes
synth frames 0 and 1 (1920x1080) as PNG, runs the oracle at sf 1.1 with
minNeighbors 3 and 0, and stores the frames' sha256 and the sorted rects
in ``data/<out>``. Needs the oracle binary (``make -C oracle
detect_oracle``) and cv2 for the PNG; the port itself needs neither.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import tempfile

from cascadeclassifier_tpu_torch.utils.synth import synth_frame

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(PKG, "data")
ORACLE = os.path.join(os.path.dirname(PKG), "oracle", "detect_oracle")


def oracle_rects(xml: str, png: str, sf: float, mn: int) -> list:
    out = subprocess.run([ORACLE, xml, png, str(sf), str(mn)],
                         capture_output=True, text=True, check=True).stdout.splitlines()
    if not out or out[0] != "LOADED":
        raise RuntimeError(f"oracle did not load {xml}")
    return sorted(list(map(int, line.split())) for line in out[1:])


def make_golden(cascade: str, frames=(0, 1), h: int = 1080, w: int = 1920,
                sf: float = 1.1) -> dict:
    import cv2

    xml = os.path.join(DATA, cascade)
    golden = {
        "about": "OpenCV 4.x C++ detectMultiScale (oracle/detect_oracle) on "
                 f"cascadeclassifier_tpu_torch.utils.synth.synth_frame(k, {h}, {w}), "
                 "rects sorted (x, y, w, h)",
        "cascade": cascade, "height": h, "width": w, "scale_factor": sf, "frames": [],
    }
    with tempfile.TemporaryDirectory() as tmp:
        for k in frames:
            img = synth_frame(k, h, w)
            png = os.path.join(tmp, f"frame{k}.png")
            cv2.imwrite(png, img)
            golden["frames"].append({
                "k": k, "sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                **{f"rects_mn{mn}": oracle_rects(xml, png, sf, mn) for mn in (3, 0)},
            })
    return golden


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cascade", help="cascade XML file name under data/")
    ap.add_argument("out", help="golden JSON file name under data/")
    args = ap.parse_args()
    golden = make_golden(args.cascade)
    with open(os.path.join(DATA, args.out), "w") as f:
        json.dump(golden, f, separators=(",", ":"))
    for g in golden["frames"]:
        print(f"frame {g['k']}: {len(g['rects_mn3'])} rects at minNeighbors 3, "
              f"{len(g['rects_mn0'])} at 0")


if __name__ == "__main__":
    main()
