"""The stage engine's cells on the CPU: the manifest's new entries, and
the readers of ``tilted_roofline``, ``stage_roofline`` and ``gate_ms`` by
hand."""

import os

import numpy as np
import pytest

from benchmark import manifest, peaks
from benchmark.metrics_ctx import Context
from benchmark.reference.detect import Counts
from benchmark.reference.detect_tilted import read_cascade

STAGE = ("void cct::tile_kernel<152, 16, 256, true, cct::GridOrigin, cct::StumpHaar, double>"
         "(cct::Frame, cct::Cascade, int, int, cct::GridOrigin)")
FRONT = STAGE.replace(", true,", ", false,")
TILTED = ("void tilted_kernel<256>(int const*, int*, int, int4 const*, int4 const*, "
          "unsigned int const*, unsigned int*, int)")


class _Trace:
    busy_s, window_s, launches = 0.5, 1.0, 160
    kernels = [(STAGE, 0.0, 2000.0), (FRONT, 0.0, 7000.0), (TILTED, 0.0, 500.0)]

    def kernel_seconds(self, pattern):
        import re

        return sum(d for n, _, d in self.kernels if re.search(pattern, n)) * 1e-6


@pytest.fixture(scope="module")
def upperbody():
    spec = manifest.cell(manifest.load(), "upperbody.video2160")
    return spec, read_cascade(os.path.join(spec["config"]["_dir"], spec["config"]["cascade"]))


def test_new_cells_find_their_files(upperbody):
    spec, c = upperbody
    assert spec["cell"]["driver"] == "detect_tilted" and spec["traffic"]["upscale"] == 2
    assert [m["name"] for m in spec["end_to_end"]] == ["frames_per_s", "frame_ms_p95", "setup_s"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "resize_ms", "group_ms", "device_idle_pct.detect", "launches_per_frame", "mfu_pct.detect",
        "syncs_per_frame", "tilted_roofline", "stage_roofline", "gate_ms"}
    assert len(c.stages) == 30 and c.tilted.any()
    f1080 = manifest.cell(manifest.load(), "frontal_alt.video1080")
    f2160 = manifest.cell(manifest.load(), "frontal_alt.video2160")
    assert f1080["traffic"]["upscale"] == 1 and f1080["cell"] == f2160["cell"]
    assert ({k: v for k, v in f1080["traffic"].items() if k not in ("about", "upscale")}
            == {k: v for k, v in f2160["traffic"].items() if k not in ("about", "upscale")})
    assert [m["name"] for m in f1080["per_layer"]] == [m["name"] for m in f2160["per_layer"]]


def test_stage_engine_readers_by_hand(upperbody):
    _, c = upperbody
    counts = Counts(len(c.stages))
    counts.levels = [(99, 199, 40), (90, 180, 30)]
    counts.stage_windows[:3] = [70, 20, 5]
    ctx = Context(trace=_Trace(), counts=counts, cascade=c, phase_ms={"gate": 3.5})
    pixels = 99 * 199 + 90 * 180
    cells = 100 * 200 + 91 * 181
    # tilted: pixels read (u8), the tilted integral written (int32), 2 000 bytes
    # and more over 3.35 TB/s against 500 µs
    want = 100 * (pixels + 4 * cells) / 3.35e12 / 500e-6
    assert manifest.reader("tilted_roofline").read(ctx) == pytest.approx(want)
    # the stage kernel: only the kStage = true instance's 2 000 µs
    ops = peaks.walk_ops(c, counts)
    assert ops == sum(n * o for n, o in zip([70, 20, 5], peaks.stage_ops(c)))
    want = 100 * peaks.least_seconds(ops, 8 * cells + 6 * 70) / 2000e-6
    assert manifest.reader("stage_roofline").read(ctx) == pytest.approx(want)
    assert manifest.reader("gate_ms").read(ctx) == 3.5
    for name in ("tilted_roofline", "stage_roofline", "gate_ms"):
        assert manifest.reader(name).read(Context()) is None
    ctx.trace.kernels = [(FRONT, 0.0, 7000.0)]  # the parent's or fused engine's trace
    assert manifest.reader("stage_roofline").read(ctx) is None
    assert manifest.reader("tilted_roofline").read(ctx) is None
    assert np.isfinite(manifest.reader("mfu_pct.detect").read(Context(
        counts=counts, cascade=c, plain_wall_s=1.0)))
