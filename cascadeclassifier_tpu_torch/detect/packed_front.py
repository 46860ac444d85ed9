"""Survivor-packed cascade front: stages [s0, s1) over a list of live
16x512 blocks of the window mask.

Counterpart of ``cascadeclassifier_tpu/detect/pallas_front.py::
make_packed_plane_front_fn`` (ystep-2 anchors) and
``make_packed_band_front_fn`` (ystep-1 band), with ``live_block_list``.
As ``front.py`` does for the dense kernels, one kernel,
``csrc/packed_front.cu``, serves both on the canvas-layout mask: its
ystep-2 rows already hold only even anchors. The block list is built on
the device from the prep mask, with no host synchronization; the kernel is
the front's tile kernel with its tiles' origins read from the list (four
16x128 tiles per entry), and the thread blocks of entries past ``nblk``
return at once. Windows outside the listed blocks keep their input value
(the JAX kernels alias the mask input to the output).

A CUDA tensor runs the kernel; a CPU tensor, or ``impl="ref"``, runs the
plain twin (``front.front_ref`` masked to the listed blocks).
"""

from __future__ import annotations

import torch

from cascadeclassifier_tpu_torch import _build
from cascadeclassifier_tpu_torch.detect.front import check_inputs, check_stages, front_ref
from cascadeclassifier_tpu_torch.detect.records import TILE_H, TILE_W

BLK_H = 16
BLK_W = 512
assert BLK_H == TILE_H and BLK_W % TILE_W == 0  # a tile never straddles two blocks


def block_grid(out_h: int, out_w: int):
    """(block rows, block cols) of an (out_h, out_w) mask; partial edge
    blocks count as blocks."""
    return -(-out_h // BLK_H), -(-out_w // BLK_W)


def live_block_list(mask):
    """(out_h, out_w) bool mask → (blk (nb_cap, 2) int32, nblk (1,) int32),
    both on the mask's device.

    blk holds the (row, col) indices of every block, those holding a set
    position first, each group in row-major order (a stable left-pack,
    as ``pallas_front.py::live_block_list``); nb_cap is the number of
    blocks and nblk the number holding a set position. Device ops only:
    no nonzero, no boolean indexing, no host read."""
    out_h, out_w = mask.shape
    nbr, nbc = block_grid(out_h, out_w)
    padded = mask.new_zeros((nbr * BLK_H, nbc * BLK_W))
    padded[:out_h, :out_w] = mask
    live = padded.view(nbr, BLK_H, nbc, BLK_W).any(dim=3).any(dim=1).reshape(-1)
    nblk = live.sum(dtype=torch.int32).reshape(1)
    ids = torch.argsort((~live).to(torch.int32), stable=True)
    blk = torch.stack([ids // nbc, ids % nbc], dim=1).to(torch.int32)
    return blk, nblk


def listed_windows(blk, nblk, out_h: int, out_w: int):
    """(out_h, out_w) bool: the windows of the blocks blk[i], i < nblk;
    entries outside the mask's blocks are skipped, as the kernel skips
    them."""
    nbr, nbc = block_grid(out_h, out_w)
    bi, bj = blk[:, 0].long(), blk[:, 1].long()
    listed = ((torch.arange(blk.shape[0], device=blk.device) < nblk)
              & (bi >= 0) & (bi < nbr) & (bj >= 0) & (bj < nbc))
    hits = torch.zeros(nbr * nbc, dtype=torch.int32, device=blk.device)
    hits.index_add_(0, torch.where(listed, bi * nbc + bj, 0), listed.to(torch.int32))
    grid = (hits > 0).view(nbr, nbc)
    return grid.repeat_interleave(BLK_H, 0).repeat_interleave(BLK_W, 1)[:out_h, :out_w]


def listed_tiles(blk, nblk: int, out_h: int, out_w: int) -> list:
    """The kernel's grid in numpy: (r0, c0, rows, cols) of the tile that
    thread block (i, x) works on, for every i < len(blk) and x <
    BLK_W // TILE_W that does not return at once. A block returns when
    i >= nblk, when blk[i] lies outside the mask's block grid, or when
    its tile starts right of the last window column."""
    nbr, nbc = block_grid(out_h, out_w)
    tiles = []
    for i, (bi, bj) in enumerate(blk):
        if i >= nblk or not (0 <= bi < nbr and 0 <= bj < nbc):
            continue
        for x in range(BLK_W // TILE_W):
            r0, c0 = int(bi) * BLK_H, int(bj) * BLK_W + x * TILE_W
            if c0 < out_w:
                tiles.append((r0, c0, min(TILE_H, out_h - r0), min(TILE_W, out_w - c0)))
    return tiles


def packed_front_ref(sum2d, inv_nf, alive, blk, nblk, cascade, s0, s1, exact=False):
    """Plain twin: inside the listed blocks alive ∧ every stage in
    [s0, s1) passed (dense ``stage_pass`` per stage); alive elsewhere."""
    out_h, out_w = alive.shape
    inside = listed_windows(blk, nblk, out_h, out_w)
    return torch.where(inside, front_ref(sum2d, inv_nf, alive & inside, cascade, s0, s1, exact),
                       alive)


def packed_front(sum2d, inv_nf, alive, blk, nblk, cascade, s0: int, s1: int,
                 impl: str = "auto", exact: bool = False):
    """sum2d (canvas_h, canvas_w) int32; inv_nf (out_h, out_w) f32; alive
    (out_h, out_w) bool; blk (nb_cap, 2) int32 and nblk (1,) int32 from
    ``live_block_list`` → alive with stages [s0, s1) of a stump Haar
    cascade applied inside the blocks blk[i], i < nblk (bool, a new
    tensor), with f32 or (exact) f64 stage sums."""
    check_stages(cascade, s0, s1)
    if cascade.kind != "stump":
        raise ValueError("packed_front takes stump Haar cascades; node trees and LBP go "
                         "to detect/front.py")
    if _build.use_ref(sum2d, impl):
        return packed_front_ref(sum2d, inv_nf, alive, blk, nblk, cascade, s0, s1, exact)
    check_inputs(sum2d, inv_nf, alive, cascade)
    dev = sum2d.device
    _build.require(blk, torch.int32, 2, "blk", dev)
    _build.require(nblk, torch.int32, 1, "nblk", dev)
    out_h, out_w = alive.shape
    if blk.shape[0] == 0 or blk.shape[1] != 2 or nblk.numel() != 1:
        raise ValueError("packed_front: blk must be (nb_cap, 2) with nb_cap > 0, nblk (1,)")
    tab = cascade.device_table(dev)
    out = alive.clone()
    code = _build.lib().cct_packed_front(
        sum2d.data_ptr(), sum2d.shape[1], inv_nf.data_ptr(),
        alive.data_ptr(), out.data_ptr(), out_h, out_w, cascade.win_h, cascade.win_w,
        blk.data_ptr(), nblk.data_ptr(), blk.shape[0], int(exact),
        tab["records"].data_ptr(), tab["pitch"], tab["stage_start"].data_ptr(),
        tab["stage_thr"].data_ptr(), s0, s1, _build.stream_of(sum2d),
    )
    _build.check(code, "cct_packed_front")
    _build.LAUNCHES["packed_front"] += 1
    return out
