// Survivor-packed cascade front: a chunk of untilted stump-Haar stages, with
// the stage sums in f32 or f64, at the alive windows of a list of live
// 16x512 blocks of the window mask.
//
// Replaces both cascadeclassifier_tpu/detect/pallas_front.py::
// make_packed_plane_front_fn (ystep-2 anchors on the parity planes) and
// make_packed_band_front_fn (the ystep-1 band). As front.cu does for their
// dense counterparts, it works in the canvas layout for both: the walk mask
// the prep hands in already holds only even anchors on ystep-2 rows, so the
// plane and band kernels become one kernel over one block list.
//
// Contract of the TPU kernels kept: blk (nb_cap, 2) int32 holds block
// (row, col) indices and *nblk_dev how many of them are live, both on the
// device, so no host sync happens. Windows of blocks that are not listed
// are not touched: the wrapper hands in alive_out as a copy of alive_in
// (the TPU kernels alias the mask input to the output).
//
// The kernel is front.cu's, cascade_tile.cuh's tile kernel without its
// dense pass, with the tile's origin read from the list: a listed block is
// 16 x 512 windows, four tiles of 16 x 128, so the grid is (nb_cap, 4) and
// thread block (i, x) takes the x-th tile of list entry i. It returns at
// once, before any barrier and with no memory touched, when i >= *nblk,
// when the entry lies outside the mask's block grid, or when the tile lies
// wholly right of the last window column (an edge block). Everything else
// is the front's: the tile's mask bytes, the dead-tile skip, the patch of
// the integral canvas in shared memory, packed tree records, block-local
// survivor lists, one coalesced byte store. A tile is as tall as a listed
// block, so it never straddles two of them. The arithmetic and its order
// are spelled out in cascade_tile.cuh.
//
// Bound: latency, as front.cu; the list only saves the dead blocks' mask
// bytes and thread blocks, which the dense front leaves after one byte read
// and one written a window. Times on the card: PERF.md.

#include "cascade_tile.cuh"

#ifndef CCT_PACKED_THREADS
#define CCT_PACKED_THREADS 256
#endif

namespace {

constexpr int kBlkH = 16;   // detect/packed_front.py: BLK_H
constexpr int kBlkW = 512;  // detect/packed_front.py: BLK_W
static_assert(kBlkW % cct::kTileW == 0, "tiles must divide a listed block");

struct ListOrigin {
  const int2* __restrict__ blk;      // (block row, block col) per entry
  const int32_t* __restrict__ nblk;  // live entries, on the device
  int nb_cap;

  __host__ dim3 grid(const cct::Frame&, int) const {
    return dim3(static_cast<unsigned>(nb_cap), kBlkW / cct::kTileW);
  }
  __device__ __forceinline__ bool operator()(const cct::Frame& f, int, int& r0,
                                             int& c0) const {
    if (static_cast<int>(blockIdx.x) >= *nblk) return false;
    const int2 b = blk[blockIdx.x];
    if (b.x < 0 || b.y < 0 || b.x >= (f.out_h + kBlkH - 1) / kBlkH ||
        b.y >= (f.out_w + kBlkW - 1) / kBlkW) {
      return false;
    }
    r0 = b.x * kBlkH;
    c0 = b.y * kBlkW + static_cast<int>(blockIdx.y) * cct::kTileW;
    return c0 < f.out_w;
  }
};

}  // namespace

// canvas (out_h + win_h, canvas_w) int32; inv (out_h, out_w) f32;
// alive_in, alive_out (out_h, out_w) u8, alive_out a copy of alive_in;
// blk (nb_cap, 2) int32 and nblk_dev (1,) int32 on the device; exact: f64
// stage sums; records (T, 48) bytes resolved against pitch. Returns the
// first CUDA error of the launch.
extern "C" int cct_packed_front(const void* canvas, int canvas_w, const void* inv,
                                const void* alive_in, void* alive_out, int out_h, int out_w,
                                int win_h, int win_w, const void* blk, const void* nblk_dev,
                                int nb_cap, int exact, const void* records, int pitch,
                                const void* stage_start, const void* stage_thr, int s0,
                                int s1, void* stream) {
  if (nb_cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cct::Frame f{static_cast<const int32_t*>(canvas), nullptr,
                     static_cast<const float*>(inv), static_cast<const uint8_t*>(alive_in),
                     static_cast<uint8_t*>(alive_out), nullptr,
                     canvas_w, out_h, out_w, win_h, win_w, 0};
  const cct::Cascade cas{static_cast<const uint4*>(records),
                         static_cast<const int32_t*>(stage_start),
                         static_cast<const float*>(stage_thr), nullptr, nullptr};
  const ListOrigin origin{static_cast<const int2*>(blk),
                          static_cast<const int32_t*>(nblk_dev), nb_cap};
  return cct::dispatch_exact<kBlkH, CCT_PACKED_THREADS, false, cct::StumpHaar>(
      exact, pitch, f, cas, s0, s1, static_cast<cudaStream_t>(stream), origin);
}
