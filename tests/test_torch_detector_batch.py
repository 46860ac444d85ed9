"""The port's detector over batches of frames and on knife-edge textures,
on the CPU: detect_multi_scale_batch with devices= (frames round-robin
over devices, each with its own cascade tables) equals the one-device
loop; the mirror of the JAX package's test_haar_parity_random_textures
holds f64 stage sums (exact=True, OpenCV's) to the OpenCV C++ oracle and
f32 sums to the JAX package's f32 detector, which departs from the oracle
on these textures in the same windows."""

import dataclasses
import os
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.detector import TPUDetector  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml as jread_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import TorchDetector  # noqa: E402
from cascadeclassifier_tpu_torch.models.xml_io import (  # noqa: E402
    read_cascade_xml,
    write_cascade_xml,
)

from .utils_synth import face_blob_image  # noqa: E402

HAAR_ALT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cascadeclassifier_tpu_torch", "data", "haarcascade_frontalface_alt.xml")


@pytest.fixture(scope="module")
def haar8(tmp_path_factory):
    """(model, xml_path): the frontal face cascade cut to 8 stages, written
    so that the oracle loads the same cut."""
    m = read_cascade_xml(HAAR_ALT)
    m8 = dataclasses.replace(m, stages=list(m.stages[:8]))
    p = str(tmp_path_factory.mktemp("trunc") / "haar8.xml")
    write_cascade_xml(m8, p)
    return m8, p


def _oracle(oracle_bin, xml, img, tmp_path, sf):
    p = str(tmp_path / "frame.png")
    cv2.imwrite(p, img)
    out = subprocess.run([oracle_bin, xml, p, str(sf), "0"], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert out[0] == "LOADED"
    return sorted(tuple(map(int, line.split())) for line in out[1:])


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_haar_parity_random_textures(oracle_bin, tmp_path, haar8, exact, seed):
    """Random blurred textures put windows near the stage thresholds. With
    f64 stage sums the port's raw windows equal the oracle's; with f32
    sums they equal the JAX package's f32 detector's (seeds 12 and 13 keep
    one window each that the oracle's f64 sums reject)."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (160, 200)).astype(np.uint8), (7, 7), 2.0)
    ours = sorted(map(tuple, TorchDetector(haar8[0], exact=exact, device="cpu")
                      .detect_multi_scale(img, 1.2, 0).tolist()))
    ref = _oracle(oracle_bin, haar8[1], img, tmp_path, 1.2)
    assert len(ref) > 0
    if exact:
        assert ours == ref
    else:
        jm = jread_cascade_xml(haar8[1])
        theirs = TPUDetector(jm, exact=False, engine="xla").detect_multi_scale(img, 1.2, 0)
        assert ours == sorted(map(tuple, np.asarray(theirs).tolist()))
        assert len(set(ours) ^ set(ref)) == (0 if seed == 11 else 1)


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu", torch.device("cpu", 0)]])
def test_detect_multi_scale_batch_devices(haar8, devices):
    det = TorchDetector(haar8[0], device="cpu")
    frames = [face_blob_image(240, 180, n=4, seed=s) for s in range(3)]
    want = [det.detect_multi_scale(f, 1.2, 2, max_det=1 << 16) for f in frames]
    got = det.detect_multi_scale_batch(frames, 1.2, 2, devices=devices)
    assert len(got) == 3 and sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a device other than the detector's gets a replica with its own tables
    assert len(det._replicas) == len({torch.device(d) for d in devices} - {det.device})
