"""Survivor patch gather (kernel 3).

Counterpart of ``cascadeclassifier_tpu/detect/compact.py::
make_pallas_patchify`` with ``emit="i32"``: for n window slots (r, c) and
a live count ``cnt``, each window's (win_h+1)×(win_w+1) integral patch is
copied into one row of an (n, P) int32 matrix; rows ≥ cnt are zero. A
CUDA tensor runs ``csrc/patchify.cu``; a CPU tensor, or ``impl="ref"``,
runs the plain twin.
"""

from __future__ import annotations

import torch

from cascadeclassifier_tpu_torch import _build


def patchify_ref(canvas, r, c, cnt: int, win_w: int, win_h: int):
    """Plain twin: advanced indexing, zeros past cnt."""
    ph, pw = win_h + 1, win_w + 1
    n = r.shape[0]
    out = torch.zeros((n, ph * pw), dtype=torch.int32, device=canvas.device)
    k = min(cnt, n)
    if k > 0:
        dy = torch.arange(ph, device=canvas.device)
        dx = torch.arange(pw, device=canvas.device)
        rows = r[:k].long()[:, None, None] + dy[None, :, None]
        cols = c[:k].long()[:, None, None] + dx[None, None, :]
        out[:k] = canvas[rows, cols].reshape(k, ph * pw)
    return out


def patchify(canvas, r, c, cnt: int, win_w: int, win_h: int, impl: str = "auto"):
    """canvas (H, W) int32; r, c (n,) int32 window origins; cnt ≤ n live
    slots → (n, (win_h+1)·(win_w+1)) int32."""
    n = r.shape[0]
    if c.shape != r.shape or not 0 <= cnt <= n:
        raise ValueError(f"patchify: r/c shapes {tuple(r.shape)}/{tuple(c.shape)}, cnt={cnt}")
    if _build.use_ref(canvas, impl):
        return patchify_ref(canvas, r, c, cnt, win_w, win_h)
    dev = canvas.device
    _build.require(canvas, torch.int32, 2, "canvas", dev)
    _build.require(r, torch.int32, 1, "r", dev)
    _build.require(c, torch.int32, 1, "c", dev)
    ph, pw = win_h + 1, win_w + 1
    out = torch.empty((n, ph * pw), dtype=torch.int32, device=canvas.device)
    code = _build.lib().cct_patchify(
        canvas.data_ptr(), canvas.shape[0], canvas.shape[1],
        r.data_ptr(), c.data_ptr(), n, cnt, ph, pw, out.data_ptr(),
        _build.stream_of(canvas),
    )
    _build.check(code, "cct_patchify")
    _build.LAUNCHES["patchify"] += 1
    return out
