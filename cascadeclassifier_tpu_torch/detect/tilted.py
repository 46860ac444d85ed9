"""Tilted canvas integral (kernel ``tilted``): the 45° integral of every
pyramid block of the pixel canvas, int32 with wrap-around mod 2^32.

Counterpart of ``cascadeclassifier_tpu/detect/dense.py::canvas_tilted``
(an XLA scan in the JAX package). A CUDA tensor runs ``csrc/tilted.cu``;
a CPU tensor, or ``impl="ref"``, runs the plain twin
(``dense.canvas_tilted``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect.dense import canvas_tilted

# the kernel's carried rows live in shared memory: 2 rows of w + 2p uint32
MAX_SHARED_BYTES = 227 * 1024


def segments(is_top: np.ndarray, pad: int) -> np.ndarray:
    """The kernel's work list: one (start, end, p, top) row per run of
    canvas rows from one block top to the next (the first run starts at
    row 0 even when it is no top); p = min(pad, rows + 1) columns of
    padding on each side (see csrc/tilted.cu)."""
    tops = np.asarray(is_top, bool)
    starts = np.union1d([0], np.nonzero(tops)[0])
    ends = np.append(starts[1:], len(tops))
    p = np.minimum(pad, ends - starts + 1)
    return np.stack([starts, ends, p, tops[starts]], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _device_segments(device: str, is_top: bytes, pad: int):
    """segments() on the device, and its largest p; one upload per plan."""
    seg = segments(np.frombuffer(is_top, bool), pad)
    return torch.as_tensor(seg, device=device), int(seg[:, 2].max())


def tilted(px, is_top, pad: int, impl: str = "auto"):
    """px (H, W) int32 pixel canvas; is_top (H,) bool block-top rows (the
    plan's numpy array); pad as ``dense.canvas_tilted`` → (H, W) int32."""
    if _build.use_ref(px, impl):
        return canvas_tilted(px, is_top, pad)
    dev = px.device
    _build.require(px, torch.int32, 2, "px", dev)
    is_top = np.asarray(is_top, bool)
    h, w = px.shape
    if is_top.shape != (h,) or pad < 0:
        raise ValueError(f"tilted: is_top shape {is_top.shape} for {h} rows, pad {pad}")
    seg, pmax = _device_segments(str(dev), is_top.tobytes(), int(pad))
    dmax = w + 2 * pmax
    if 2 * dmax * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"tilted: {w} columns + 2x{pmax} padding exceed shared memory")
    out = torch.empty_like(px)
    code = _build.lib().cct_tilted(
        px.data_ptr(), out.data_ptr(), h, w, seg.data_ptr(), seg.shape[0], dmax,
        _build.stream_of(px),
    )
    _build.check(code, "cct_tilted")
    _build.LAUNCHES["tilted"] += 1
    return out
