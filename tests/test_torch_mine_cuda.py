"""The dense miner's kernel (csrc/mine.cu) on the card: equal to its plain
version, mine_ref, on utils/edges.py's miner edges. Skips without a CUDA
device; imports no JAX."""

import pytest

torch = pytest.importorskip("torch")

from cascadeclassifier_tpu_torch import _build  # noqa: E402
from cascadeclassifier_tpu_torch.utils import edges  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mine_kernel_edge_cases(cuda_device):
    """csrc/mine.cu equals mine_ref on the card on every miner edge, one
    launch a case."""
    before = _build.LAUNCHES["mine"]
    n_cases, _windows, bad = edges.mine_edge_mismatches(cuda_device)
    assert not bad
    assert _build.LAUNCHES["mine"] == before + n_cases
