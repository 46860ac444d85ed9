// Survivor-packed cascade front: a chunk of untilted stump-Haar stages at
// the alive windows of a list of live 16x512 blocks of the window mask.
//
// Replaces both cascadeclassifier_tpu/detect/pallas_front.py::
// make_packed_plane_front_fn (ystep-2 anchors on the parity planes) and
// make_packed_band_front_fn (the ystep-1 band). As front.cu does for their
// dense counterparts, it works in the canvas layout for both: the walk mask
// the prep hands in already holds only even anchors on ystep-2 rows, so the
// plane and band kernels become one kernel over one block list.
//
// Contract of the TPU kernels kept: blk (nb_cap, 2) int32 holds block
// (row, col) indices and *nblk_dev how many of them are live; the grid has
// nb_cap thread blocks and block i returns at once when i >= *nblk (read on
// the device, so no host sync happens). Windows of blocks that are not
// listed are not touched: the wrapper hands in alive_out as a copy of
// alive_in (the TPU kernels alias the mask input to the output).
//
// Inside a listed block: 512 threads, one per column, so neighbouring
// threads read neighbouring canvas columns and the loads coalesce; each
// thread walks the block's 16 rows, clipped to (out_h, out_w). A window
// that is not alive costs one byte read and one written; an alive one runs
// stages [s0, s1) in order and stops at the first it fails. The arithmetic
// is front.cu's, kept as a copy here (a device function shared with
// front.cu slowed the front by ~10 % when stage.cu tried it):
//   rect  = C[y][x] - C[y][x+w] - C[y+h][x] + C[y+h][x+w]   (uint32 wrap,
//           exact because the true sum fits int32)
//   raw   = f32(rect0)*w0 + f32(rect1)*w1 (+ ...), rects of weight 0 skipped
//   val   = raw * inv_nf;  leaf = val < thr ? left : right
//   ssum  = ssum + leaf, one add per tree in tree order
// and the stage passes iff ssum >= stage_thr; built with --fmad=false.
//
// Bound: the same canvas gathers as front.cu for the same alive windows;
// what the list saves is the launch over dead blocks (a dead window costs
// front.cu two bytes). The TPU kernel's tile DMA into VMEM is not mirrored:
// the (16+win_h+1) x (512+win_w+1) canvas tile stays in L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlkH = 16;
constexpr int kBlkW = 512;

__global__ void __launch_bounds__(kBlkW) packed_front_kernel(
    const int32_t* __restrict__ canvas, int canvas_w, const float* __restrict__ inv,
    const uint8_t* __restrict__ alive_in, uint8_t* __restrict__ alive_out, int out_h,
    int out_w, const int2* __restrict__ blk, const int32_t* __restrict__ nblk,
    const int4* __restrict__ rects, const float* __restrict__ wts,
    const float* __restrict__ tparam, const int32_t* __restrict__ stage_start,
    const float* __restrict__ stage_thr, int s0, int s1) {
  if (static_cast<int>(blockIdx.x) >= *nblk) return;
  const int2 b = blk[blockIdx.x];  // (block row, block col)
  if (b.x < 0 || b.y < 0 || b.x >= (out_h + kBlkH - 1) / kBlkH) return;
  const long long cl = static_cast<long long>(b.y) * kBlkW + threadIdx.x;
  if (cl >= out_w) return;
  const int c = static_cast<int>(cl);
  const int r0 = b.x * kBlkH;
  const int r1 = min(r0 + kBlkH, out_h);
  for (int r = r0; r < r1; ++r) {
    const size_t i = static_cast<size_t>(r) * out_w + c;
    if (!alive_in[i]) {
      alive_out[i] = 0;
      continue;
    }
    const uint32_t* base = reinterpret_cast<const uint32_t*>(canvas) +
                           static_cast<size_t>(r) * canvas_w + c;
    const float inv_nf = inv[i];
    uint8_t alive = 1;
    for (int s = s0; s < s1 && alive; ++s) {
      float ssum = 0.0f;
      const int t1 = stage_start[s + 1];
      for (int t = stage_start[s]; t < t1; ++t) {
        float raw = 0.0f;
        bool first = true;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float wt = wts[t * 3 + k];
          if (wt == 0.0f) continue;
          const int4 q = rects[t * 3 + k];  // x, y, w, h
          const uint32_t* p0 = base + static_cast<size_t>(q.y) * canvas_w + q.x;
          const uint32_t* p1 = p0 + static_cast<size_t>(q.w) * canvas_w;
          const uint32_t u = p0[0] - p0[q.z] - p1[0] + p1[q.z];
          const float term = static_cast<float>(static_cast<int32_t>(u)) * wt;
          raw = first ? term : raw + term;
          first = false;
        }
        const float val = raw * inv_nf;
        const float* tp = tparam + t * 3;  // thr, left, right
        ssum = ssum + (val < tp[0] ? tp[1] : tp[2]);
      }
      alive = ssum >= stage_thr[s];
    }
    alive_out[i] = alive;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int cct_packed_front(const void* canvas, int canvas_w, const void* inv,
                                const void* alive_in, void* alive_out, int out_h, int out_w,
                                const void* blk, const void* nblk_dev, int nb_cap,
                                const void* rects, const void* wts, const void* tparam,
                                const void* stage_start, const void* stage_thr, int s0,
                                int s1, void* stream) {
  if (out_h <= 0 || out_w <= 0 || nb_cap <= 0 || s1 < s0)
    return static_cast<int>(cudaErrorInvalidValue);
  packed_front_kernel<<<static_cast<unsigned>(nb_cap), kBlkW, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(canvas), canvas_w, static_cast<const float*>(inv),
      static_cast<const uint8_t*>(alive_in), static_cast<uint8_t*>(alive_out), out_h,
      out_w, static_cast<const int2*>(blk), static_cast<const int32_t*>(nblk_dev),
      static_cast<const int4*>(rects), static_cast<const float*>(wts),
      static_cast<const float*>(tparam), static_cast<const int32_t*>(stage_start),
      static_cast<const float*>(stage_thr), s0, s1);
  return static_cast<int>(cudaGetLastError());
}
