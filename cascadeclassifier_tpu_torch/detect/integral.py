"""Canvas integrals (kernel 1): inclusive 2-D prefix sums of the pixel
canvas and of its square, int32 with wrap-around mod 2^32.

Counterpart of ``cascadeclassifier_tpu/detect/pallas_integral.py::
make_integral_fn`` (and of the chained ``jnp.cumsum`` in
``detector.py::_build_canvas``). A CUDA tensor runs ``csrc/integral.cu``;
a CPU tensor, or ``impl="ref"``, runs the plain PyTorch twin. The pixel
canvas is uint8 (the fused engine's) or int32 (the stage engine's).
"""

from __future__ import annotations

import torch

from cascadeclassifier_tpu_torch import _build

# The kernel's geometry (csrc/integral.cu: CCT_INTEGRAL_ROWS,
# CCT_INTEGRAL_THREADS, CCT_INTEGRAL_COLS, CCT_INTEGRAL_STRIP): rows a band,
# threads of the apply pass and adjacent columns a thread of it, columns a
# block of the carry scan, whose 1024 threads split a column's bands into
# CARRY_GROUPS groups.
BAND_ROWS = 32
APPLY_THREADS = 256
APPLY_COLS = 8
CARRY_STRIP = 32
CARRY_GROUPS = 1024 // CARRY_STRIP
PX_DTYPES = (torch.uint8, torch.int32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2^32 (two's complement), explicitly."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def integral_ref(px: torch.Tensor):
    """Plain twin: int64 cumsums (torch.cumsum promotes int32 to int64
    anyway), narrowed to int32 mod 2^32."""
    p = px.to(torch.int64)
    s = torch.cumsum(torch.cumsum(p, dim=1), dim=0)
    q = torch.cumsum(torch.cumsum(p * p, dim=1), dim=0)
    return wrap_i32(s), wrap_i32(q)


def integral(px: torch.Tensor, impl: str = "auto"):
    """px (H, W) uint8 or int32 pixel canvas → (sum, sq), both (H, W)
    int32."""
    if _build.use_ref(px, impl):
        return integral_ref(px)
    _build.require(px, PX_DTYPES, 2, "px", px.device)
    h, w = px.shape
    lib = _build.lib()
    s = torch.empty((h, w), dtype=torch.int32, device=px.device)
    q = torch.empty_like(s)
    n = -(-h // BAND_ROWS) - 1  # bands whose sums feed a carry
    tot = torch.empty((max(2 * n * w, 1),), dtype=torch.int32, device=px.device)
    code = lib.cct_integral(
        px.data_ptr(), px.element_size(), s.data_ptr(), q.data_ptr(), tot.data_ptr(),
        h, w, BAND_ROWS, _build.stream_of(px),
    )
    _build.check(code, "cct_integral")
    _build.LAUNCHES["integral"] += 1
    return s, q
