// Cascade front: a chunk of untilted stages at every alive window of the
// canvas, for stump-Haar, Haar node-tree and LBP cascades, with the stage
// sums in f32 or f64.
//
// Replaces both cascadeclassifier_tpu/detect/pallas_front.py::
// make_static_front_fn (ystep-1 band, body _run_stages) and
// make_plane_front_fn (ystep-2 levels on the even-anchor parity planes).
// Their output contract is the same survivor mask; here it is computed in
// the canvas layout for both: the walk mask the prep hands in already
// holds only even anchors on ystep-2 rows, so no parity planes exist. The
// JAX package runs the f64, node-tree and LBP stages of its fused engine
// in XLA (dense_stage_*); here they run in the same kernel under other
// tree and sum policies.
//
// The kernel is cascade_tile.cuh's tile kernel without its dense pass: a
// block owns a tile of kTileH x 128 windows, leaves a tile with no alive
// window after reading its mask bytes only, and otherwise copies the
// tile's patch of the integral canvas into shared memory, compacts the
// alive windows into a list and runs the stages [s0, s1) over the list,
// compacting the survivors after every stage, so every lane of a working
// warp holds a live window. Tree parameters come as packed records
// (detect/records.py) whose corner offsets are resolved against the shared
// patch. The arithmetic and its order are spelled out in cascade_tile.cuh.
// This file instantiates the stump-Haar policy; node trees and LBP are in
// tile_node.cu and tile_lbp.cu.
//
// Bound: latency. After prep about one window in twenty is alive, so a
// live tile holds a short list whose windows each wait on a chain of
// dependent trees (a record's three loads, 4 shared-memory gathers a rect,
// the f32 chain), and the lists shrink stage by stage; the tile kernel
// answers with more lanes a window. Device memory is not the limit: a dead
// tile costs one byte read and one byte written a window, which is what
// the byte bound counts, and a live one its patch, about 2.5 canvas cells
// a window with the halo, mostly from L2. Times on the card: PERF.md.

#include "cascade_tile.cuh"

// canvas (out_h + win_h, canvas_w) int32; inv (out_h, out_w) f32 (null
// for LBP); alive_in, alive_out (out_h, out_w) u8; kind (cct::Kind) and
// exact (f64 stage sums) pick the policies; records resolved against pitch,
// tree_root and leaves for node trees (null for stumps). Returns the first
// CUDA error of the launch.
extern "C" int cct_front(const void* canvas, int canvas_w, const void* inv,
                         const void* alive_in, void* alive_out, int out_h, int out_w,
                         int win_h, int win_w, int kind, int exact, const void* records,
                         int pitch, const void* tree_root, const void* leaves,
                         const void* stage_start, const void* stage_thr, int s0, int s1,
                         void* stream) {
  const cct::Frame f{static_cast<const int32_t*>(canvas), nullptr,
                     static_cast<const float*>(inv), static_cast<const uint8_t*>(alive_in),
                     static_cast<uint8_t*>(alive_out), nullptr,
                     canvas_w, out_h, out_w, win_h, win_w, 0};
  const cct::Cascade cas{static_cast<const uint4*>(records),
                         static_cast<const int32_t*>(stage_start),
                         static_cast<const float*>(stage_thr),
                         static_cast<const int32_t*>(tree_root),
                         static_cast<const float*>(leaves)};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case cct::kStump:
      return cct::dispatch_exact<CCT_FRONT_TILE_H, CCT_FRONT_THREADS, false, cct::StumpHaar>(
          exact, pitch, f, cas, s0, s1, st);
    case cct::kNode:
      return cct::front_node(exact, pitch, f, cas, s0, s1, st);
    case cct::kLbp:
      return cct::front_lbp(exact, pitch, f, cas, s0, s1, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
