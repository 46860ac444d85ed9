"""The port's tools (cascadeclassifier_tpu_torch/tools/) and traces
(utils/profiling.py) on the CPU: tests/test_tools.py's 9 tests on the
port's modules, and the port held against the JAX package's tools on
the same inputs (.vec bytes, the parameter echo, detection lines)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from cascadeclassifier_tpu.tools import createsamples as jcs  # noqa: E402
from cascadeclassifier_tpu.tools import detect_cli as jdetect_cli  # noqa: E402
from cascadeclassifier_tpu.tools import traincascade_cli as jtraincascade_cli  # noqa: E402
from cascadeclassifier_tpu_torch.data.vec import read_vec  # noqa: E402
from cascadeclassifier_tpu_torch.tools.annotation import (  # noqa: E402
    normalize_rect,
    read_annotations,
    write_annotations,
)
from cascadeclassifier_tpu_torch.tools.createsamples import (  # noqa: E402
    CvRNG,
    create_samples_from_info,
    create_training_samples,
)
from cascadeclassifier_tpu_torch.utils import profiling  # noqa: E402

from .test_tools import REF_IMG, REF_VEC, golden  # the reference's golden .vec  # noqa: E402
from .utils_synth import face_blob_image  # noqa: E402

FRONTAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "cascadeclassifier_tpu_torch", "data", "haarcascade_frontalface_alt.xml")


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_cvrng_known_sequence():
    """cv::RNG MWC generator: state transition sanity, and the JAX copy's
    draws."""
    r = CvRNG(12345)
    vals = [r.next() for _ in range(3)]
    assert all(0 <= v < 2**32 for v in vals)
    r2 = CvRNG(12345)
    assert [r2.next() for _ in range(3)] == vals
    jr = jcs.CvRNG(12345)
    assert [jr.next() for _ in range(3)] == vals
    r, jr = CvRNG(7), jcs.CvRNG(7)
    assert [r.uniform_double(-1.0, 1.0) for _ in range(5)] == [
        jr.uniform_double(-1.0, 1.0) for _ in range(5)]


@golden
def test_createsamples_bit_parity_with_reference_golden(tmp_path):
    """The reference's expected_barcode.vec (createsamples -img ean13.png
    -num 100 -maxxangle 0 -maxyangle 0 -maxzangle 1.6 -w 75 -h 32)."""
    out = str(tmp_path / "b.vec")
    create_training_samples(out, REF_IMG, 100, maxxangle=0, maxyangle=0, maxzangle=1.6,
                            win_w=75, win_h=32, rngseed=12345)
    np.testing.assert_array_equal(read_vec(out, 75, 32), read_vec(REF_VEC, 75, 32))


def _object_png(d):
    """A 40x30 object (bright card, dark bars) on a background of 0."""
    rng = np.random.default_rng(2)
    img = np.zeros((30, 40), np.uint8)
    img[3:27, 4:36] = rng.integers(150, 256, (24, 32))
    img[8:22:4, 8:32] = 20
    path = str(d / "obj.png")
    cv2.imwrite(path, img)
    return path


@pytest.mark.parametrize("with_bg", [False, True])
def test_training_samples_match_original(tmp_path, with_bg):
    """-img -vec: the JAX function's .vec bytes for the same seed and
    arguments, over a flat background and over backgrounds mined by the
    port's NegReader (against the JAX package's)."""
    img = _object_png(tmp_path)
    bg = None
    if with_bg:
        rng = np.random.default_rng(4)
        for k in range(2):
            cv2.imwrite(str(tmp_path / f"bg{k}.png"), rng.integers(0, 256, (60, 80), np.uint8))
        bg = str(tmp_path / "bg.txt")
        with open(bg, "w") as f:
            f.write("".join(str(tmp_path / f"bg{k}.png") + "\n" for k in range(2)))
    kw = dict(bg_path=bg, maxxangle=0.8, maxyangle=0.8, maxzangle=0.4, win_w=24, win_h=20,
              rngseed=99)
    assert create_training_samples(str(tmp_path / "port.vec"), img, 30, **kw) == 30
    jcs.create_training_samples(str(tmp_path / "jax.vec"), img, 30, **kw)
    ours = (tmp_path / "port.vec").read_bytes()
    assert ours == (tmp_path / "jax.vec").read_bytes()
    assert len(np.unique(read_vec(str(tmp_path / "port.vec"), 24, 20))) > 50


def test_info_to_vec(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 80)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "img.png"), img)
    with open(tmp_path / "ann.dat", "w") as f:
        f.write("img.png 2 5 5 40 30 40 10 16 16\n")
    out = str(tmp_path / "o.vec")
    n = create_samples_from_info(str(tmp_path / "ann.dat"), out, 10, 24, 24)
    assert n == 2
    v = read_vec(out, 24, 24)
    # first rect downsizes with INTER_AREA — compare against cv2 directly
    ref0 = cv2.resize(img[5:35, 5:45], (24, 24), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(v[0], ref0)
    # the second upsizes with INTER_LINEAR_EXACT: the JAX function's bytes
    jout = str(tmp_path / "j.vec")
    assert jcs.create_samples_from_info(str(tmp_path / "ann.dat"), jout, 10, 24, 24) == 2
    assert (tmp_path / "o.vec").read_bytes() == (tmp_path / "j.vec").read_bytes()


def test_annotation_roundtrip(tmp_path):
    assert normalize_rect(10, 20, 4, 6) == (4, 6, 6, 14)
    ann = {"a.png": [(1, 2, 3, 4), (5, 6, 7, 8)], "b.png": []}
    p = str(tmp_path / "ann.txt")
    write_annotations(p, ann)
    assert read_annotations(p) == ann


def test_createsamples_cli_info_mode(tmp_path):
    """torch-createsamples -info -vec, as createsamples.cpp dispatches it."""
    from cascadeclassifier_tpu_torch.tools.createsamples_cli import main

    cv2.imwrite(str(tmp_path / "img.png"), np.full((40, 40), 128, np.uint8))
    (tmp_path / "ann.dat").write_text("img.png 1 2 2 30 30\n")
    rc, out = _stdout(main, ["-info", str(tmp_path / "ann.dat"), "-vec",
                             str(tmp_path / "o.vec"), "-w", "20", "-h", "20"])
    assert rc == 0 and out.strip() == "Done. Created 1 samples"
    assert read_vec(str(tmp_path / "o.vec"), 20, 20).shape == (1, 20, 20)


def test_traincascade_cli_help():
    from cascadeclassifier_tpu_torch.tools.traincascade_cli import build_parser

    p = build_parser()
    a = p.parse_args(["-data", "d", "-vec", "v", "-bg", "b", "-numPos", "5", "-featureType",
                      "LBP", "-w", "16", "-h", "12", "-bt", "RAB"])
    assert a.numPos == 5 and a.featureType == "LBP" and a.win_w == 16
    assert a.device == "cuda" and a.distBackend is None


def test_traincascade_cli_feature_count_line():
    """The parameter echo prints the reference transcript's unique feature
    count (res/README.md: 152,625 LBP features at 75x32), and is the JAX
    CLI's echo line for line."""
    from cascadeclassifier_tpu_torch.tools.traincascade_cli import (
        build_parser,
        make_trainer,
        print_parameters,
    )

    argv = ["-data", "d", "-vec", "v", "-bg", "b", "-featureType", "LBP", "-w", "75", "-h", "32"]
    args = build_parser().parse_args(argv + ["-device", "cpu"])
    _, out = _stdout(print_parameters, args, make_trainer(args))
    assert "given windowSize [75,32] : 152625" in out
    jargs = jtraincascade_cli.build_parser().parse_args(argv)
    _, jout = _stdout(jtraincascade_cli.print_parameters, jargs,
                      jtraincascade_cli.make_trainer(jargs))
    assert out.splitlines() == jout.splitlines()


def test_visualisation(tmp_path):
    from cascadeclassifier_tpu_torch.tools.visualisation_cli import main

    out = str(tmp_path / "vis")
    assert main(["--model", FRONTAL, "--data", out, "--scale", "4"]) == 0
    assert len(os.listdir(out)) == 22


def test_visualisation_video(tmp_path):
    """--video writes one frame per weak feature (reference
    opencv_visualisation.cpp:182-192, 235-276), as the JAX tool does."""
    from cascadeclassifier_tpu.tools import visualisation_cli as jvis

    from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml
    from cascadeclassifier_tpu_torch.tools.visualisation_cli import main

    counts = {}
    for name, fn in (("port", main), ("jax", jvis.main)):
        out = str(tmp_path / name)
        assert fn(["--model", FRONTAL, "--data", out, "--scale", "4", "--video"]) == 0
        vids = [f for f in os.listdir(out) if f.startswith("model_visualization")]
        assert len(vids) == 1
        cap = cv2.VideoCapture(os.path.join(out, vids[0]))
        assert cap.isOpened()
        counts[name] = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), len(os.listdir(out)))
        cap.release()
    model = read_cascade_xml(FRONTAL)
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == sum(t.num_nodes for s in model.stages for t in s.trees)


def test_detect_cli_routes_hog_cascade(tmp_path, capsys):
    """torch-detect serves a HOG cascade through HOGDetector (OpenCV's
    runtime serves none)."""
    from cascadeclassifier_tpu_torch.models.model import (
        FEATURE_HOG,
        CascadeModel,
        HOGFeature,
        Stage,
        WeakTree,
    )
    from cascadeclassifier_tpu_torch.models.xml_io import write_cascade_xml
    from cascadeclassifier_tpu_torch.ops.features import hog_catalog
    from cascadeclassifier_tpu_torch.tools.detect_cli import main

    cat = hog_catalog(32, 32)
    tree = WeakTree(left=np.array([-1], np.int32), right=np.array([-2], np.int32),
                    feature_idx=np.array([0], np.int32), threshold=np.array([0.5], np.float32),
                    leaf_values=np.array([0.0, -1.0, 1.0], np.float32))
    # accept-everything stage: routing is what is under test
    model = CascadeModel(
        feature_type=FEATURE_HOG, width=32, height=32,
        stages=[Stage(threshold=-10.0, trees=[tree])],
        features=[HOGFeature(rect=tuple(int(v) for v in cat.rects[0]), component=0)],
        feat_size=36,
    ).validate()
    xml = str(tmp_path / "hog.xml")
    write_cascade_xml(model, xml)
    img = np.random.default_rng(0).integers(0, 256, (40, 44)).astype(np.uint8)
    png = str(tmp_path / "scene.png")
    cv2.imwrite(png, img)
    rc = main([xml, png, "--scale-factor", "1.2", "--min-neighbors", "1", "--device", "cpu"])
    assert rc == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    # the accept-all cascade must fire on the grid
    assert len(out) >= 1 and all(len(ln.split()) == 4 for ln in out)
    assert "HOG" in captured.err
    with pytest.raises(SystemExit):  # the JAX package's "xla" engine is not ported
        main([xml, png, "--engine", "xla", "--device", "cpu"])


@pytest.mark.parametrize("fast", [False, True])
def test_detect_cli_matches_original(tmp_path, fast):
    """torch-detect --device cpu prints the JAX detect CLI's lines in the
    same order on a face-blob image (frontal face, sf 1.2, minNeighbors
    1), f64 and f32 sums, through the plain level stack (--engine pallas)
    and through "auto" (the fused engine on its shelf-packed plan, which
    hands grouping its windows in the plain stack's order); -o writes the
    annotated image."""
    img = face_blob_image(240, 180, n=4, seed=2)
    png = str(tmp_path / "faces.png")
    cv2.imwrite(png, img)
    argv = [FRONTAL, png, "--scale-factor", "1.2", "--min-neighbors", "1"] + (
        ["--fast"] if fast else [])
    from cascadeclassifier_tpu_torch.tools.detect_cli import main

    jrc, jout = _stdout(jdetect_cli.main, argv)
    rc, out = _stdout(main, argv + ["--device", "cpu", "--engine", "pallas"])
    assert rc == jrc == 0
    assert out.splitlines() == jout.splitlines() and len(out.splitlines()) >= 3
    rc, out = _stdout(main, argv + ["--device", "cpu", "-o", str(tmp_path / "vis.png")])
    assert rc == 0 and out.splitlines() == jout.splitlines()
    assert cv2.imread(str(tmp_path / "vis.png")).shape == (180, 240, 3)


def test_trace_and_annotate_write_a_trace(tmp_path):
    """trace() writes a Chrome trace holding a span() range and the
    operations inside it; summary() lists every timed scope."""
    log = str(tmp_path / "trace")
    profiling.reset()
    with profiling.trace(log) as prof:
        with profiling.span("smoke.scope"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = os.listdir(log)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "smoke.scope" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "smoke.scope" for e in prof.key_averages())
    assert [s.name for s in profiling.spans()] == ["smoke.scope"]
    profiling.reset()
    profiling.reset_timings()
    with profiling.timed("phase_a"):
        pass
    with profiling.timed("phase_a"):
        pass
    line = profiling.summary().splitlines()
    assert len(line) == 1 and line[0].startswith("phase_a") and "n=   2" in line[0]
