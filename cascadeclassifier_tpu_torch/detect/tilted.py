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

# The kernel's pieces of work: CHUNK_ROWS computed rows of a segment by
# STRIP_COLS of its padded columns (csrc/tilted.cu: CCT_TILTED_CHUNK,
# CCT_TILTED_STRIP).
CHUNK_ROWS = 64
STRIP_COLS = 256


def segments(is_top: np.ndarray, pad: int) -> np.ndarray:
    """The kernel's segments: one (start, end, p, top) row per run of
    canvas rows from one block top to the next (the first run starts at
    row 0 even when it is no top). p is the padding on each side: with n
    computed rows (the run's rows but its top) a value further than
    (n − 1) // 2 columns from [0, W) is zero or reaches no column of
    [0, W) any more, so p = min(pad, (n − 1) // 2) (see csrc/tilted.cu)."""
    tops = np.asarray(is_top, bool)
    starts = np.union1d([0], np.nonzero(tops)[0])
    ends = np.append(starts[1:], len(tops))
    n = ends - starts - tops[starts]
    p = np.minimum(pad, np.maximum(n - 1, 0) // 2)
    return np.stack([starts, ends, p, tops[starts]], axis=1).astype(np.int32)


def work_list(seg: np.ndarray, w: int):
    """The kernel's thread blocks for a canvas w wide → (items (N, 4)
    int32, offsets (launches + 1,) int32). An item is (segment, first
    computed row of its chunk, first owned column of its strip, 0); launch
    c runs the items [offsets[c], offsets[c + 1]): chunk c of every
    segment that has one, each cut into strips. A segment that is a top
    alone has one item in launch 0, which writes its zero row."""
    launches = []
    for s, (start, end, p, top) in enumerate(np.asarray(seg).tolist()):
        n = end - start - top
        for c, q0 in enumerate(range(0, max(n, 1), CHUNK_ROWS)):
            if c == len(launches):
                launches.append([])
            launches[c] += [(s, q0, ka, 0) for ka in range(0, w + 2 * p, STRIP_COLS)]
    items = np.array([it for launch in launches for it in launch], np.int32).reshape(-1, 4)
    offsets = np.cumsum([0] + [len(launch) for launch in launches]).astype(np.int32)
    return items, offsets


@functools.lru_cache(maxsize=16)
def _device_work(device: str, is_top: bytes, pad: int, w: int):
    """segments() and work_list() on the device (the launch offsets stay
    on the host), and the widest padded row; one upload per plan."""
    seg = segments(np.frombuffer(is_top, bool), pad)
    items, offsets = work_list(seg, w)
    return (torch.as_tensor(seg, device=device), torch.as_tensor(items, device=device),
            offsets, w + 2 * int(seg[:, 2].max()))


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
    seg, items, offsets, dstate = _device_work(str(dev), is_top.tobytes(), int(pad), w)
    out = torch.empty_like(px)
    # the carried rows between two chunks of a segment, written by one
    # launch and read by the next
    state = torch.empty((2, seg.shape[0], 2, dstate), dtype=torch.int32, device=dev)
    code = _build.lib().cct_tilted(
        px.data_ptr(), out.data_ptr(), h, w, seg.data_ptr(), seg.shape[0],
        items.data_ptr(), offsets.ctypes.data, len(offsets) - 1, state.data_ptr(), dstate,
        _build.stream_of(px),
    )
    _build.check(code, "cct_tilted")
    _build.LAUNCHES["tilted"] += 1
    return out
