// Cascade front: a chunk of untilted stump-Haar stages at every alive
// window of the canvas.
//
// Replaces both cascadeclassifier_tpu/detect/pallas_front.py::
// make_static_front_fn (ystep-1 band, body _run_stages) and
// make_plane_front_fn (ystep-2 levels on the even-anchor parity planes).
// Their output contract is the same survivor mask; here it is computed in
// the canvas layout for both: the walk mask the prep hands in already
// holds only even anchors on ystep-2 rows, so no parity planes exist.
//
// One thread per canvas window. A window that is not alive exits at once;
// an alive one runs the stages [s0, s1) in order and stops at the first
// stage it fails. Per tree, as dense_stage_haar(exact=False) does:
//   rect  = C[y][x] - C[y][x+w] - C[y+h][x] + C[y+h][x+w]   (uint32 wrap,
//           exact because the true sum fits int32)
//   raw   = f32(rect0)*w0 + f32(rect1)*w1 (+ ...), rects of weight 0 skipped
//   val   = raw * inv_nf;  leaf = val < thr ? left : right
//   ssum  = ssum + leaf, one add per tree in tree order
// and the stage passes iff ssum >= stage_thr. Built with --fmad=false so
// no multiply-add is contracted into an FMA (the reference rounds twice).
//
// Tree parameters live in device buffers (rects (T,3,4) int32, weights
// (T,3) f32, (thr, left, right) (T,3) f32, stage_start (S+1), stage_thr
// (S)), so one binary serves every cascade; every thread of a warp reads
// the same parameter, which the cache broadcasts.
//
// Bound: canvas gathers. An alive window reads 4 corners per rect from a
// 21x21 patch of the integral canvas; neighbouring threads read
// neighbouring columns, so the loads coalesce and the patch stays in L1/L2.
// Dead windows cost one byte read and one byte written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void front_kernel(const int32_t* __restrict__ canvas, int canvas_w,
                             const float* __restrict__ inv, const uint8_t* __restrict__ alive_in,
                             uint8_t* __restrict__ alive_out, int out_h, int out_w,
                             const int4* __restrict__ rects, const float* __restrict__ wts,
                             const float* __restrict__ tparam,
                             const int32_t* __restrict__ stage_start,
                             const float* __restrict__ stage_thr, int s0, int s1) {
  const long long n = static_cast<long long>(out_h) * out_w;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!alive_in[i]) {
    alive_out[i] = 0;
    return;
  }
  const int r = static_cast<int>(i / out_w);
  const int c = static_cast<int>(i - static_cast<long long>(r) * out_w);
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

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int cct_front(const void* canvas, int canvas_w, const void* inv,
                         const void* alive_in, void* alive_out, int out_h, int out_w,
                         const void* rects, const void* wts, const void* tparam,
                         const void* stage_start, const void* stage_thr, int s0, int s1,
                         void* stream) {
  const long long n = static_cast<long long>(out_h) * out_w;
  if (n <= 0 || s1 < s0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  front_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(canvas), canvas_w, static_cast<const float*>(inv),
      static_cast<const uint8_t*>(alive_in), static_cast<uint8_t*>(alive_out), out_h,
      out_w, static_cast<const int4*>(rects), static_cast<const float*>(wts),
      static_cast<const float*>(tparam), static_cast<const int32_t*>(stage_start),
      static_cast<const float*>(stage_thr), s0, s1);
  return static_cast<int>(cudaGetLastError());
}
