"""Canvas integrals of the PyTorch port (kernel 1) against the JAX package.

The port's plain twin must equal, mod 2^32, the Pallas integral kernel
(interpret mode) and the chained XLA cumsum, on a uint8 canvas as on an
int32 one; the CUDA kernel's algorithm, mirrored in numpy, must equal the
twin at its edges; the CUDA kernel must equal the twin on the card."""

import os
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cascadeclassifier_tpu.detect.pallas_integral import make_integral_fn  # noqa: E402
from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.detect.integral import (  # noqa: E402
    APPLY_COLS,
    APPLY_THREADS,
    BAND_ROWS,
    CARRY_GROUPS,
    CARRY_STRIP,
    PX_DTYPES,
    integral,
    wrap_i32,
)
from cascadeclassifier_tpu_torch.utils.edges import (  # noqa: E402
    integral_edge_cases,
    integral_edge_mismatches,
)

N_EDGE_CASES = 80


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


def test_twin_on_u8_matches_pallas_integral_kernel_on_int32():
    """The fused engine's uint8 canvas through the twin equals the Pallas
    kernel on the int32 of the same values."""
    rng = np.random.default_rng(10)
    px = rng.integers(0, 256, (512, 256)).astype(np.uint8)  # two row blocks
    c, csq = make_integral_fn(512, 256, True, interpret=True)(jnp.asarray(px.astype(np.int32)))
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


@pytest.mark.parametrize(
    "bad", [torch.float32, torch.int64, torch.int16, torch.int8, torch.bool, torch.float16]
)
def test_rejects_unknown_impl_device_and_bad_tensors(bad):
    with pytest.raises(ValueError):
        integral(torch.zeros((4, 4), dtype=torch.int32), impl="fast")
    with pytest.raises(ValueError):  # no kernel and no twin for this device
        integral(torch.zeros((4, 4), dtype=torch.int32, device="meta"))
    for ok in PX_DTYPES:  # what the kernel takes
        t = torch.zeros((4, 4), dtype=ok)
        _build.require(t, PX_DTYPES, 2, "t", t.device)
        with pytest.raises(ValueError):
            _build.require(t, PX_DTYPES, 2, "t", torch.device("meta"))
        with pytest.raises(ValueError):
            _build.require(t, PX_DTYPES, 1, "t", t.device)
        with pytest.raises(ValueError):
            _build.require(t.t(), PX_DTYPES, 2, "t", t.device)
    with pytest.raises(TypeError):
        _build.require(torch.zeros((4, 4), dtype=bad), PX_DTYPES, 2, "t", torch.device("cpu"))
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        _build.require(t, torch.float32, 2, "t", t.device)


def _kernel_in_numpy(px):
    """csrc/integral.cu's algorithm in uint32 numpy, launch by launch:
    band_sums over bands 0 .. nb-2; band_carry with its groups of bands,
    the groups' totals joined, then the inclusive scan in place; band_apply
    per band and pass of APPLY_THREADS x APPLY_COLS columns, each thread's
    adjacent columns from the carry, the prefix along them, the warp's
    exclusive scan of the thread totals, the staged row, the offset of the
    warp that owns a column and the row carry of the passes before (the
    kernel stores a row in 128-byte-aligned runs, an order that changes no
    value). Every output cell starts as a marker and counts its writes."""
    h, w = px.shape
    v = px.astype(np.int64).astype(np.uint32)
    nb = -(-h // BAND_ROWS)
    n = nb - 1
    tot = np.zeros((2, n, w), np.uint32)
    for b in range(n):
        band = v[b * BAND_ROWS : (b + 1) * BAND_ROWS]
        tot[0, b] = band.sum(0, dtype=np.uint32)
        tot[1, b] = (band * band).sum(0, dtype=np.uint32)
    g = -(-n // CARRY_GROUPS)
    spans = [(min(n, y * g), min(n, min(n, y * g) + g)) for y in range(CARRY_GROUPS)]
    part = np.stack([tot[:, k0:k1].sum(1, dtype=np.uint32) for k0, k1 in spans], 1)
    before = np.cumsum(part, 1, dtype=np.uint32) - part  # the groups above each group
    for y, (k0, k1) in enumerate(spans):
        tot[:, k0:k1] = before[:, y, None] + np.cumsum(tot[:, k0:k1], 1, dtype=np.uint32)
    out = np.full((2, h, w), 0x5A5A5A5A, np.uint32)
    writes = np.zeros((h, w), np.int32)
    n_pass = APPLY_THREADS * APPLY_COLS
    warps = APPLY_THREADS // 32
    owner = np.arange(n_pass) // (32 * APPLY_COLS)
    for b in range(nb):
        r0, rows = b * BAND_ROWS, min(BAND_ROWS, h - b * BAND_ROWS)
        rcar = np.zeros((2, rows), np.uint32)
        for p0 in range(0, w, n_pass):
            cols = p0 + np.arange(n_pass)
            on = cols < w
            acc = np.zeros((2, n_pass), np.uint32)
            if b > 0:
                acc[:, on] = tot[:, b - 1, cols[on]]
            for i in range(rows):
                cur = np.zeros(n_pass, np.uint32)
                cur[on] = v[r0 + i, cols[on]]
                acc[0] += cur
                acc[1] += cur * cur
                local = np.cumsum(acc.reshape(2, APPLY_THREADS, APPLY_COLS), 2, dtype=np.uint32)
                totals = local[:, :, -1].reshape(2, warps, 32)
                incl = np.cumsum(totals, 2, dtype=np.uint32)
                staged = (local + (incl - totals).reshape(2, APPLY_THREADS, 1)).reshape(2, -1)
                wt = incl[:, :, -1]
                wex = np.cumsum(wt, 1, dtype=np.uint32) - wt
                final = staged + wex[:, owner] + rcar[:, i, None]
                out[:, r0 + i, cols[on]] = final[:, on]
                writes[r0 + i, cols[on]] += 1
                rcar[:, i] += wt.sum(1, dtype=np.uint32)
    assert (writes == 1).all()
    return out[0].view(np.int32), out[1].view(np.int32)


def test_kernel_geometry_matches_the_cuda_macros():
    """detect/integral.py's constants name csrc/integral.cu's defaults."""
    with open(os.path.join(_build.CSRC_DIR, "integral.cu")) as f:
        src = f.read()

    def macro(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert macro("CCT_INTEGRAL_ROWS") == BAND_ROWS
    assert macro("CCT_INTEGRAL_THREADS") == APPLY_THREADS
    assert macro("CCT_INTEGRAL_COLS") == APPLY_COLS
    assert macro("CCT_INTEGRAL_STRIP") == CARRY_STRIP == 1024 // CARRY_GROUPS


@pytest.mark.parametrize("case", range(N_EDGE_CASES))
def test_kernel_algorithm_matches_twin_on_the_edge_cases(case):
    """utils/edges.py's canvases: heights of one band, one row short of, at
    and past a band and three bands and a part; widths of one column, a
    warp and its neighbours, the 1080p and 4K canvases and one pass and
    past it; uint8, and int32 values up to 2^20, where both sums wrap."""
    px = list(integral_edge_cases())[case]
    got = _kernel_in_numpy(px)
    want = integral(torch.from_numpy(px))
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r.numpy())
    if px.dtype == np.int32 and px.size >= 1 << 13:
        assert px.sum(dtype=np.int64) >= 1 << 31  # the sum wraps, as the square does


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device):
    rng = np.random.default_rng(3)
    px = torch.from_numpy(rng.integers(0, 256, (1000, 777)).astype(np.int32)).to(cuda_device)
    s_k, q_k = integral(px)
    s_r, q_r = integral(px, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_r) and torch.equal(q_k, q_r)
    s_8, q_8 = integral(px.to(torch.uint8))  # the same values as uint8
    torch.cuda.synchronize()
    assert torch.equal(s_8, s_r) and torch.equal(q_8, q_r)


@pytest.mark.cuda
def test_kernel_matches_twin_on_the_edge_cases_on_card(cuda_device):
    n, bad = integral_edge_mismatches(cuda_device)
    torch.cuda.synchronize()
    assert n == N_EDGE_CASES and not bad, bad
