"""f64 stage sums (``exact=True``, the default of both packages) in the
PyTorch port against the JAX package: the twin's stage sums bit for bit,
the record mirror, the tail, the detector's raw windows through both port
engines, and a knife-edge cascade on which f32 and f64 sums differ, held
against the OpenCV oracle too. Every comparison is exact (bit for bit, or
equal sets of windows)."""

import os
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect import dense as jdense  # noqa: E402
from cascadeclassifier_tpu.detect.detector import (  # noqa: E402
    PackedCascade as JPackedCascade,
)
from cascadeclassifier_tpu.detect.detector import TPUDetector  # noqa: E402
from cascadeclassifier_tpu.models.xml_io import (  # noqa: E402
    read_cascade_xml as jread_cascade_xml,
)
from cascadeclassifier_tpu_torch.convert import from_jax_packed  # noqa: E402
from cascadeclassifier_tpu_torch.detect import dense, records  # noqa: E402
from cascadeclassifier_tpu_torch.detect.compact import TailTables, tail  # noqa: E402
from cascadeclassifier_tpu_torch.detect.detector import (  # noqa: E402
    PackedCascade,
    TorchDetector,
)
from cascadeclassifier_tpu_torch.models.xml_io import read_cascade_xml  # noqa: E402
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    edge_mismatches,
    knife_edge_model,
    packed_edge_mismatches,
    policy_ranges,
    truncated,
)

DATA = os.path.join(  # the port's vendored copies of OpenCV's files
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cascadeclassifier_tpu_torch", "data",
)
HAAR_ALT = os.path.join(DATA, "haarcascade_frontalface_alt.xml")
UPPERBODY = os.path.join(DATA, "haarcascade_upperbody.xml")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _canvases(seed, out_h, out_w, win_w, win_h):
    """A seeded integral canvas, a tilted canvas of arbitrary int32 values
    and a positive inv_nf, as numpy."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (out_h + win_h, out_w + win_w)).astype(np.int64)
    sum2d = (px.cumsum(0).cumsum(1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    tilt2d = rng.integers(-(1 << 31), 1 << 31, sum2d.shape).astype(np.int32)
    inv_nf = rng.uniform(1e-4, 2e-2, (out_h, out_w)).astype(np.float32)
    return sum2d, tilt2d, inv_nf


def _sorted(rects):
    return sorted(map(tuple, np.asarray(rects).tolist()))


@pytest.mark.parametrize("xml,stage_ids", [(HAAR_ALT, (0, 2, 5)), (UPPERBODY, (0, 3))])
def test_dense_stage_haar_exact_matches_jax_bitwise(xml, stage_ids):
    """f64 stage sums of whole stages at every position of a random canvas
    (tilted trees from a random tilted canvas), bit for bit."""
    jp = JPackedCascade.from_model(jread_cascade_xml(xml))
    cas = from_jax_packed(jp)
    out_h, out_w = 23, 41
    s, t, inv = _canvases(len(stage_ids), out_h, out_w, cas.win_w, cas.win_h)
    for si in stage_ids:
        with jax.enable_x64(True):
            want = np.asarray(jdense.dense_stage_haar(
                jnp.asarray(s), jnp.asarray(t), jp.stages[si], out_h, out_w, jnp.asarray(inv),
                exact=True))
        got = dense.dense_stage_haar(torch.from_numpy(s), cas.stages[si], out_h, out_w,
                                     torch.from_numpy(inv), torch.from_numpy(t),
                                     exact=True).numpy()
        assert want.dtype == got.dtype == np.float64
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
        f32 = dense.dense_stage_haar(torch.from_numpy(s), cas.stages[si], out_h, out_w,
                                     torch.from_numpy(inv), torch.from_numpy(t)).numpy()
        assert f32.dtype == np.float32 and not np.array_equal(f32.astype(np.float64), got)


@pytest.mark.parametrize("xml,si", [(HAAR_ALT, 3), (UPPERBODY, 2)])
def test_exact_records_mirror_matches_twin(xml, si):
    """The stump records evaluated tile by tile in f64 as the kernels do,
    against dense.stage_pass(exact=True)."""
    cas = PackedCascade.from_model(read_cascade_xml(xml))
    st = cas.stages[si]
    out_h, out_w = records.TILE_H + 3, records.TILE_W + 5
    s, t, inv = _canvases(si, out_h, out_w, cas.win_w, cas.win_h)
    rec = records.tree_records([st], cas.win_w, cas.win_h)
    want = dense.stage_pass(torch.from_numpy(s), st, out_h, out_w, torch.from_numpy(inv),
                            torch.from_numpy(t), exact=True).numpy()
    got = records.records_stage_pass(rec, st.threshold, s, t if cas.has_tilted else None, inv,
                                     cas.win_w, cas.win_h, exact=True)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_exact_tail_matches_gathered_twin():
    """The torch tail in f64 on patches of a random canvas keeps the
    windows that pass window_stage_pass(exact=True) at every stage."""
    cas = PackedCascade.from_model(read_cascade_xml(HAAR_ALT))
    out_h, out_w = 30, 50
    s, _, inv = _canvases(7, out_h, out_w, cas.win_w, cas.win_h)
    s_t, inv_t = torch.from_numpy(s), torch.from_numpy(inv)
    idx = torch.arange(out_h * out_w)
    r, c = idx // out_w, idx % out_w
    offs = (torch.arange(cas.win_h + 1)[:, None] * s.shape[1]
            + torch.arange(cas.win_w + 1)[None, :]).reshape(-1)
    patches = s_t.reshape(-1)[(r * s.shape[1] + c)[:, None] + offs[None, :]]
    stage_ids = range(1, 4)
    keep = tail(patches, inv_t.reshape(-1), TailTables(cas, stage_ids, "cpu"), exact=True)
    want = idx
    for si in stage_ids:
        ok = dense.window_stage_pass(s_t, None, cas.stages[si], want, out_w,
                                     inv_t.reshape(-1)[want], exact=True)
        want = want[ok]
    assert 0 < len(want) < out_h * out_w
    np.testing.assert_array_equal(keep.numpy(), want.numpy())


def test_exact_slice_matches_jax_xla_engine():
    """The frontal face cut to 5 stages, exact=True (the default): raw
    windows through the fused engine (stages 1-2 in the front, 3-4 in
    the f64 tail) and the stage engine equal TPUDetector(engine="xla",
    exact=True)'s, sf 1.2, minNeighbors 0."""
    from .utils_synth import face_blob_image

    pytest.importorskip("cv2")
    img = face_blob_image(200, 150, n=4, seed=7)
    want = _sorted(TPUDetector(truncated(jread_cascade_xml(HAAR_ALT), 5), exact=True,
                               engine="xla").detect_multi_scale(img, 1.2, 0))
    m = truncated(read_cascade_xml(HAAR_ALT), 5)
    fused = TorchDetector(m, device="cpu", front_trees=20)
    assert fused.exact and fused.engine_name == "fused" and fused.engine.n_dense == 3
    got = _sorted(fused.detect_multi_scale(img, 1.2, 0))
    assert fused.engine.last_counts["front_survivors"] > 0  # the tail ran
    assert len(want) > 0 and got == want
    assert _sorted(TorchDetector(m, device="cpu", engine="pallas")
                   .detect_multi_scale(img, 1.2, 0)) == want


@pytest.fixture(scope="module")
def knife(tmp_path_factory):
    """The knife-edge cascade (built on the port's reading of the frontal
    face) written as XML by the port's writer and read back by both
    packages, on a face-blob frame at sf 1.2, with the JAX xla
    engine's raw rects in both modes."""
    from cascadeclassifier_tpu_torch.models.xml_io import write_cascade_xml

    from .utils_synth import face_blob_image

    pytest.importorskip("cv2")
    xml = str(tmp_path_factory.mktemp("knife") / "knife.xml")
    write_cascade_xml(knife_edge_model(read_cascade_xml(HAAR_ALT)), xml)
    img = face_blob_image(240, 180, n=6, seed=3)
    jm = jread_cascade_xml(xml)
    jax_rects = {exact: _sorted(TPUDetector(jm, exact=exact, engine="xla")
                                .detect_multi_scale(img, 1.2, 0)) for exact in (False, True)}
    return xml, img, jax_rects


@pytest.mark.parametrize("engine", ["fused", "pallas"])
def test_knife_edge_modes_differ_and_match_jax(knife, engine):
    """f32 and f64 sums of the same leaves fall on both sides of the stage
    threshold at some windows, so the two modes give different raw windows
    (not nested: a window's stage-0 result steers the walk's skip of the
    next); each mode equals the JAX package's in the same mode."""
    xml, img, jax_rects = knife
    m = read_cascade_xml(xml)
    got = {exact: _sorted(TorchDetector(m, exact=exact, device="cpu", engine=engine)
                          .detect_multi_scale(img, 1.2, 0)) for exact in (False, True)}
    assert got == jax_rects
    assert len(got[False]) > 0 and len(got[True]) > 0 and got[False] != got[True]


def test_knife_edge_exact_matches_opencv_oracle(knife, oracle_bin, tmp_path):
    """OpenCV sums in double: the oracle's raw rects are the exact mode's,
    not the f32 mode's."""
    import cv2

    xml, img, _ = knife
    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, img)
    out = subprocess.run([oracle_bin, xml, png, "1.2", "0"], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert out[0] == "LOADED"
    ref = sorted(tuple(map(int, line.split())) for line in out[1:])
    det = TorchDetector(read_cascade_xml(xml), device="cpu")
    assert det.exact
    assert _sorted(det.detect_multi_scale(img, 1.2, 0)) == ref
    f32 = TorchDetector(read_cascade_xml(xml), exact=False, device="cpu")
    assert _sorted(f32.detect_multi_scale(img, 1.2, 0)) != ref


@pytest.mark.cuda
def test_exact_kernels_match_twins_at_tile_edges_on_card(cuda_device):
    """front, stage and packed_front with f64 sums on the frontal face and
    the knife-edge cascade, and stage on the tilted upper body."""
    frontal = PackedCascade.from_model(read_cascade_xml(HAAR_ALT))
    knife_cas = PackedCascade.from_model(knife_edge_model(read_cascade_xml(HAAR_ALT)))
    body = PackedCascade.from_model(read_cascade_xml(UPPERBODY))
    for cas in (frontal, knife_cas, body):
        n = len(cas.stages)
        for use_stage in (True, False):
            if cas.has_tilted and not use_stage:
                continue
            _, _, bad = edge_mismatches(cas, policy_ranges(n, use_stage), cuda_device,
                                        use_stage, exact=True)
            torch.cuda.synchronize()
            assert not bad
    _, survivors, bad = packed_edge_mismatches(frontal, cuda_device, exact=True)
    torch.cuda.synchronize()
    assert not bad and survivors > 0
