"""Hold a committed smoke golden against the JAX package's own f32 path.

    JAX_PLATFORMS=cpu python -m tests.check_golden_with_jax \\
        smoke_golden_upperbody_1080p.json [engine]

runs ``TPUDetector(cascade, exact=False, engine=...)`` (``compact`` by
default) on each golden frame and prints whether its rects equal the
golden's at minNeighbors 3 and 0; exits 1 if any differs. At 1080p on
a CPU this takes about a minute a frame.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

from cascadeclassifier_tpu.detect.detector import TPUDetector
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml
from cascadeclassifier_tpu_torch.utils.synth import synth_frame

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "cascadeclassifier_tpu_torch", "data")


def main():
    name = sys.argv[1]
    engine = sys.argv[2] if len(sys.argv) > 2 else "compact"
    with open(os.path.join(DATA, name)) as f:
        golden = json.load(f)
    det = TPUDetector(read_cascade_xml(os.path.join(DATA, golden["cascade"])),
                      exact=False, engine=engine)
    ok = True
    for g in golden["frames"]:
        img = synth_frame(g["k"], golden["height"], golden["width"])
        assert hashlib.sha256(img.tobytes()).hexdigest() == g["sha256"]
        for mn in (3, 0):
            t0 = time.perf_counter()
            got = sorted(map(list, np.asarray(
                det.detect_multi_scale(img, golden["scale_factor"], mn)).tolist()))
            same = got == g[f"rects_mn{mn}"]
            ok &= same
            print(f"frame {g['k']} minNeighbors {mn}: {len(got)} rects, "
                  f"{'equal to' if same else 'DIFFERENT from'} the golden's "
                  f"{len(g[f'rects_mn{mn}'])} ({time.perf_counter() - t0:.1f} s, "
                  f"engine {engine})", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
