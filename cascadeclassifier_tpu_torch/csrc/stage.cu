// Stage kernel: stump-Haar stages [s0, s1), upright and tilted features,
// at every alive window of the canvas, with stage 0's pass mask collected.
//
// Replaces cascadeclassifier_tpu/detect/pallas_stage.py::
// make_pallas_chunk_fn (the engine="pallas" kernel). Its output contract:
//   alive'  = alive AND every stage in [s0, s1) passed
//   passed0 = stage 0's pass mask at EVERY window when s0 == 0 (the walk's
//             skip trigger, collect_passed0), zeros otherwise
// The TPU kernel's layout workarounds are not carried over: the tilted
// canvas needs no TILT_BIAS lane offset (x - h >= 0 is checked at pack
// time), rows need no 8-aligned loads, lanes no rolls, and the stages need
// no SMEM-sized chunking, so one launch takes the whole cascade.
//
// The kernel is cascade_tile.cuh's tile kernel with its dense pass: a
// block owns a tile of kTileH x 128 windows and holds the tile's patches
// of the integral canvas and (for a cascade with tilted trees) of the
// tilted canvas in shared memory. Stage 0, due at every window because its
// pass mask is an output, runs densely with several rows of one column a
// thread; the stages after it run over the block's list of alive windows,
// compacted again after every stage. When s0 > 0 a tile with no alive
// window is left after its mask bytes were read. Tree parameters come as
// packed 48-byte records (detect/records.py); a tilted tree's corners
// point into the tilted patch, so both kinds of tree run the same code.
// The arithmetic and its order are spelled out in cascade_tile.cuh.
//
// Bound: stage 0 is most of the arithmetic (every window, about ten
// shared-memory gathers and a record's three loads a tree) and its dense
// pass runs near one gather instruction a cycle an SM; the stages after it
// are bound by latency, short lists of windows that each wait on a chain
// of dependent trees, and take the larger half of the time. Device memory
// is not the limit: both canvases, inv_nf and the masks are read once from
// device memory or L2, the canvases about 2.5 times with the tiles' halos.
// Times on the card: PERF.md.

#include "cascade_tile.cuh"

#ifndef CCT_STAGE_TILE_H
#define CCT_STAGE_TILE_H 16
#endif
#ifndef CCT_STAGE_THREADS
#define CCT_STAGE_THREADS 256
#endif

// sum, tilt: (out_h + win_h, canvas_w) int32 canvases (tilt is read only
// when has_tilt); inv (out_h, out_w) f32; alive_in, alive_out, passed0
// (out_h, out_w) u8; records (T, 48) bytes resolved against pitch and a
// tile of tile_h rows (the tilted patch's offset depends on it). Returns
// the first CUDA error of the launch.
extern "C" int cct_stage(const void* sum, const void* tilt, int has_tilt, int canvas_w,
                         const void* inv, const void* alive_in, void* alive_out,
                         void* passed0, int out_h, int out_w, int win_h, int win_w,
                         const void* records, int pitch, int tile_h, const void* stage_start,
                         const void* stage_thr, int s0, int s1, void* stream) {
  if (tile_h != CCT_STAGE_TILE_H) return static_cast<int>(cudaErrorInvalidValue);
  const cct::Frame f{static_cast<const int32_t*>(sum), static_cast<const int32_t*>(tilt),
                     static_cast<const float*>(inv), static_cast<const uint8_t*>(alive_in),
                     static_cast<uint8_t*>(alive_out), static_cast<uint8_t*>(passed0),
                     canvas_w, out_h, out_w, win_h, win_w, has_tilt};
  const cct::Cascade cas{static_cast<const uint4*>(records),
                         static_cast<const int32_t*>(stage_start),
                         static_cast<const float*>(stage_thr)};
  return cct::dispatch<CCT_STAGE_TILE_H, CCT_STAGE_THREADS, true>(
      pitch, f, cas, s0, s1, static_cast<cudaStream_t>(stream));
}
