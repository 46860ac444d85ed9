"""Canvas integrals of the PyTorch port (kernel 1) against the JAX package.

The port's plain twin must equal, mod 2^32, the Pallas integral kernel
(interpret mode) and the chained XLA cumsum; the CUDA kernel must equal
the twin on the card."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.pallas_integral import make_integral_fn  # noqa: E402
from cascadeclassifier_tpu_torch.detect.integral import integral, wrap_i32  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _np_wrapped_integral(px):
    c = np.cumsum(np.cumsum(px.astype(np.int64), 1), 0)
    return ((c + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def test_twin_matches_pallas_integral_kernel():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (512, 384)).astype(np.int32)  # two row blocks
    c, csq = make_integral_fn(512, 384, True, interpret=True)(jnp.asarray(px))
    s, q = integral(torch.from_numpy(px))
    assert s.dtype == q.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(c))
    np.testing.assert_array_equal(q.numpy(), np.asarray(csq))


def test_twin_matches_xla_cumsum_with_wraparound():
    """Large values push the sums past 2^31: both sides wrap identically."""
    rng = np.random.default_rng(1)
    px = rng.integers(0, 1 << 15, (200, 173)).astype(np.int32)
    x = jnp.asarray(px)
    want_s = jnp.cumsum(jnp.cumsum(x, axis=1, dtype=jnp.int32), axis=0, dtype=jnp.int32)
    want_q = jnp.cumsum(
        jnp.cumsum(x * x, axis=1, dtype=jnp.int32), axis=0, dtype=jnp.int32
    )
    s, q = integral(torch.from_numpy(px))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))


def test_wraparound_matches_numpy_int64():
    rng = np.random.default_rng(2)
    px = rng.integers(0, 1 << 20, (150, 130)).astype(np.int32)
    full = np.cumsum(np.cumsum(px.astype(np.int64), 1), 0)
    assert full.max() > 2**31  # the check is not vacuous
    s, _ = integral(torch.from_numpy(px))
    np.testing.assert_array_equal(s.numpy(), _np_wrapped_integral(px))
    v = torch.tensor([2**31, 2**32 + 5, -1, -(2**31) - 1], dtype=torch.int64)
    assert wrap_i32(v).tolist() == [-(2**31), 5, -1, 2**31 - 1]


def test_rejects_unknown_impl_device_and_bad_tensors():
    from cascadeclassifier_tpu_torch import _build

    with pytest.raises(ValueError):
        integral(torch.zeros((4, 4), dtype=torch.int32), impl="fast")
    with pytest.raises(ValueError):  # no kernel and no twin for this device
        integral(torch.zeros((4, 4), dtype=torch.int32, device="meta"))
    t = torch.zeros((4, 4), dtype=torch.int32)
    _build.require(t, torch.int32, 2, "t", t.device)
    with pytest.raises(ValueError):
        _build.require(t, torch.int32, 2, "t", torch.device("meta"))
    with pytest.raises(TypeError):
        _build.require(t, torch.float32, 2, "t", t.device)
    with pytest.raises(ValueError):
        _build.require(t, torch.int32, 1, "t", t.device)
    with pytest.raises(ValueError):
        _build.require(t.t(), torch.int32, 2, "t", t.device)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device):
    rng = np.random.default_rng(3)
    px = torch.from_numpy(rng.integers(0, 256, (1000, 777)).astype(np.int32)).to(cuda_device)
    s_k, q_k = integral(px)
    s_r, q_r = integral(px, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_r) and torch.equal(q_k, q_r)
