"""Survivor patch gather of the PyTorch port (kernel 3) against the JAX
package's Pallas patchify kernel (interpret mode, emit="i32")."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.compact import (  # noqa: E402
    make_pallas_patchify,
    pad_canvas_for_patchify,
)
from cascadeclassifier_tpu_torch.detect.patchify import patchify  # noqa: E402

H, W, WIN, N, CNT = 200, 240, 20, 64, 37


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _inputs():
    rng = np.random.default_rng(5)
    canvas = rng.integers(-(2**31), 2**31 - 1, (H, W), dtype=np.int64).astype(np.int32)
    r = rng.integers(0, H - WIN - 1, N).astype(np.int32)
    c = rng.integers(0, W - WIN - 1, N).astype(np.int32)
    return canvas, r, c


def test_twin_matches_pallas_patchify_i32():
    canvas, r, c = _inputs()
    fn, _ = make_pallas_patchify(WIN, WIN, H, W, N, interpret=True, emit="i32")
    want = np.asarray(
        fn(pad_canvas_for_patchify(jnp.asarray(canvas), WIN), jnp.asarray(r),
           jnp.asarray(c), jnp.int32(CNT))
    )
    got = patchify(torch.from_numpy(canvas), torch.from_numpy(r), torch.from_numpy(c),
                   CNT, WIN, WIN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (N, (WIN + 1) ** 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[CNT:].any()  # slots past cnt are zero
    for w in (0, CNT - 1):  # and live rows hold the window's patch
        patch = canvas[r[w]:r[w] + WIN + 1, c[w]:c[w] + WIN + 1].reshape(-1)
        np.testing.assert_array_equal(got[w].numpy(), patch)


def test_rejects_bad_count():
    canvas, r, c = _inputs()
    with pytest.raises(ValueError):
        patchify(torch.from_numpy(canvas), torch.from_numpy(r), torch.from_numpy(c),
                 N + 1, WIN, WIN)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device):
    canvas, r, c = (torch.from_numpy(a).to(cuda_device) for a in _inputs())
    for cnt in (0, CNT, N):
        got = patchify(canvas, r, c, cnt, WIN, WIN)
        want = patchify(canvas, r, c, cnt, WIN, WIN, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
